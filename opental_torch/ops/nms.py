"""Soft-NMS: exact-parity numpy version + batched device version.

Counterpart of `opental_tpu/ops/nms.py`; reference softnms_v2
(AFSD/common/segment_utils.py:128-162): greedy gaussian decay
exp(-iou^2 / sigma), score floor 1e-3, top-k cap, extra columns
(uncertainty / actionness) passed through.

`soft_nms_device` runs the same greedy recursion as the JAX package's
lax.while_loop version on fixed-shape blocks, batched over a leading
axis (one row per class, or per (video, class)), and picks its path by
the blocks' device:
* blocks on the card take the hand kernel (`ops/soft_nms_cuda.py`,
  `csrc/soft_nms.cu`): every block's whole pick loop in one launch, of
  any length, with no synchronisation (half-precision blocks are
  widened to float32 first; other dtypes raise);
* blocks on the CPU take `soft_nms_plain`, the loop in plain PyTorch:
  ~34 small launches a pick, and a check for termination once every
  `check_every` picks, so it syncs the host that rarely instead of once
  per pick (a finished row is left unchanged by the extra steps).
Both keep the same rows with the same scores. Counter
(`utils/profiling`): `nms.steps`, the pick loop's iterations, once a
call: the plain loop's (rounded up to its checks), or the kernel's
longest row's picks, read from its counts when the recording is read.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from opental_torch.ops import soft_nms_cuda
from opental_torch.utils import profiling

SCORE_FLOOR = 1e-3


def soft_nms_numpy(segments: np.ndarray, sigma: float = 0.5,
                   top_k: int = 1000, score_threshold: float = SCORE_FLOOR,
                   ) -> Tuple[np.ndarray, int]:
    """segments: (N, D>=3) [start, end, score, *extras]. Returns (kept
    (M, D) rows in original index order with scores as of pick time, M).
    Greedy: pick the argmax score among undone, gaussian-decay the
    overlapping undone scores, repeat while more than one undone score is
    >= threshold and fewer than top_k are picked."""
    segments = np.asarray(segments, np.float32).copy()
    tstart, tend = segments[:, 0], segments[:, 1]
    tscore = segments[:, 2]
    done = np.zeros(len(segments), bool)
    undone = tscore >= score_threshold
    while undone.sum() > 1 and done.sum() < top_k:
        idx = np.flatnonzero(undone)[tscore[undone].argmax()]
        undone[idx] = False
        done[idx] = True
        u = undone
        tt1 = np.maximum(tstart[u], tstart[idx])
        tt2 = np.minimum(tend[u], tend[idx])
        inter = np.maximum(tt2 - tt1, 0)
        width = max(tend[idx] - tstart[idx], 1e-5)
        iou = inter / (width + (tend[u] - tstart[u]) - inter)
        tscore[u] *= np.exp(-iou ** 2 / sigma)
        undone[tscore < score_threshold] = False
    segments[:, 2] = tscore
    kept = segments[done]
    return kept, int(done.sum())


def soft_nms_device(segments: torch.Tensor, sigma: float = 0.5,
                    top_k: int = 200, score_threshold: float = SCORE_FLOOR,
                    valid: Optional[torch.Tensor] = None,
                    check_every: int = 64
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Soft-NMS over padded blocks, batched.

    segments: (..., N, D) float32 [start, end, score, ...]; valid:
    (..., N) bool (False for padding rows). Returns (segments with decayed
    scores and a kept-flag column appended -> (..., N, D+1), picked count
    per block (...)). Unpicked rows have flag 0. The kernel where the
    blocks are on the card (float32 out), else `soft_nms_plain`
    (check_every is its host check's interval).
    """
    if not segments.is_cuda:
        return soft_nms_plain(segments, sigma, top_k, score_threshold,
                              valid, check_every)
    if segments.dtype in (torch.float16, torch.bfloat16):
        segments = segments.float()
    if valid is not None:
        valid = valid.reshape(segments.shape[:-1]).contiguous()
    out, count = soft_nms_cuda.soft_nms(segments.contiguous(), valid,
                                        sigma, top_k, score_threshold)
    # the longest row's picks, read when the recording is: no sync here
    profiling.count('nms.steps',
                    lambda: int(count.max()) if count.numel() else 0)
    return out, count


def soft_nms_plain(segments: torch.Tensor, sigma: float = 0.5,
                   top_k: int = 200, score_threshold: float = SCORE_FLOOR,
                   valid: Optional[torch.Tensor] = None,
                   check_every: int = 64
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`soft_nms_device`'s recursion in plain PyTorch, on the blocks'
    device: one pick of every block a step, and a host check for
    termination every `check_every` steps."""
    batch_shape = segments.shape[:-2]
    n, d = segments.shape[-2:]
    seg = segments.reshape(-1, n, d)
    start, end = seg[..., 0], seg[..., 1]
    scores = seg[..., 2].clone()
    length = end - start
    undone = scores >= score_threshold
    if valid is not None:
        undone &= valid.reshape(-1, n)
    kept = torch.zeros_like(undone)
    count = torch.zeros(seg.shape[0], dtype=torch.int64,
                        device=seg.device)
    cols = torch.arange(n, device=seg.device)
    neg_inf = torch.tensor(float('-inf'), device=seg.device,
                           dtype=scores.dtype)
    steps = min(n, top_k)
    for step in range(steps):
        # after every step undone implies score >= threshold, so the JAX
        # loop's active set is `undone`
        go = (undone.sum(-1) > 1) & (count < top_k)
        if step % check_every == 0 and not bool(go.any()):
            steps = step
            break
        idx = torch.where(undone, scores, neg_inf).argmax(-1, keepdim=True)
        pick = (cols == idx) & go[:, None]
        undone &= ~pick
        kept |= pick
        s_i = start.gather(1, idx)
        e_i = end.gather(1, idx)
        inter = (torch.minimum(end, e_i) - torch.maximum(start, s_i)
                 ).clamp(min=0.0)
        width = (e_i - s_i).clamp(min=1e-5)
        iou = inter / (width + length - inter)
        decay = torch.exp(-iou ** 2 / sigma)
        scores = torch.where(undone & go[:, None], scores * decay, scores)
        undone &= scores >= score_threshold
        count += go.long()
    profiling.count('nms.steps', steps)
    out = torch.cat([seg[..., :2], scores[..., None], seg[..., 3:],
                     kept[..., None].to(seg.dtype)], dim=-1)
    return out.reshape(batch_shape + (n, d + 1)), count.reshape(batch_shape)
