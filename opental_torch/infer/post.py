"""Post-processing: decoded candidates to proposals, for every inference
path (THUMOS14 windows on the device or the host, ActivityNet batches on
the device or the host, OpenMax's recalibrated scores).

Reference AFSD/thumos14/test.py:143-200 and anet/test.py:130-239. Per
class column, a candidate is kept when its score is over `floor` and,
with the actionness gate, its actionness over 0.5; the kept candidates
go through greedy gaussian soft-NMS and each surviving row
[start s, end s, score, (uncertainty), (actionness)] becomes one
proposal dict. Two ways to the same rows:

* `device_blocks`: every (video, class) at once on the tensors' device:
  a top-`n_candidates` preselect by a stable sort (equal scores in index
  order, as `lax.top_k`), then one batched `ops/nms.soft_nms_device`
  call (B5 on the card, one launch). The floor is compared in the
  scores' dtype: callers pass bfloat16 scores to compare in bfloat16.
* `host_rows`: the reference's loop, a mask and numpy soft-NMS per
  class.

`device_rows` reads a block's kept rows; `proposals` formats the rows.
Spans (`utils/profiling`): `post.preselect` and `post.soft_nms` in
`device_blocks`, `post.soft_nms` around each class's soft-NMS in
`host_rows`.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from opental_torch.ops.nms import SCORE_FLOOR, soft_nms_device, \
    soft_nms_numpy
from opental_torch.utils import profiling

ACT_GATE = 0.5          # test.py:135, anet/test.py:135

Rows = Iterable[Tuple[int, np.ndarray]]     # (class column, kept rows)


def class_columns(num_classes: int, os_head: bool) -> List[int]:
    """The score columns that are classes: all of them under os_head,
    else every one but the background column 0."""
    return list(range(num_classes)) if os_head else \
        list(range(1, num_classes))


def device_blocks(seconds: torch.Tensor, scores: torch.Tensor,
                  unct: Optional[torch.Tensor], act: Optional[torch.Tensor],
                  cls_cols: Sequence[int], floor: float, gate: bool,
                  n_candidates: int, sigma: float, top_k: int,
                  nms_floor: float = SCORE_FLOOR) -> torch.Tensor:
    """(B, C, k, D + 1) soft-NMS blocks of B videos' candidates: seconds
    (B, N, 2), scores (B, N, K), the extra columns unct and act (B, N)
    each or None; C = len(cls_cols), k = min(n_candidates, N), D = 3 +
    the extras. The last column flags the kept rows (`device_rows`)."""
    with profiling.span('post.preselect'):
        sc = scores[..., cls_cols].transpose(1, 2)            # (B, C, N)
        keep = sc > floor
        if gate:
            keep = keep & (act > ACT_GATE)[:, None]
        sc = torch.where(keep, sc, 0.0)
        top, idx = torch.sort(sc, dim=-1, descending=True, stable=True)
        k = min(n_candidates, sc.shape[-1])
        top, idx = top[..., :k], idx[..., :k]                 # (B, C, k)

        def take(v):                            # (B, N, d) -> (B, C, k, d)
            return torch.gather(
                v[:, None].expand(-1, idx.shape[1], -1, -1), 2,
                idx[..., None].expand(-1, -1, -1, v.shape[-1]))

        cols = [take(seconds), top[..., None].float()]
        cols += [take(e[..., None]).float() for e in (unct, act)
                 if e is not None]
        cands = torch.cat(cols, dim=-1)
    with profiling.span('post.soft_nms'):
        blocks, _ = soft_nms_device(cands, sigma=sigma, top_k=top_k,
                                    score_threshold=nms_floor,
                                    valid=top > 0)
    return blocks


def device_rows(blocks: np.ndarray, cls_cols: Sequence[int]) -> Rows:
    """(class, kept rows without the flag column) of a video's (C, k,
    D + 1) blocks from `device_blocks`, fetched to the host."""
    for cl, block in zip(cls_cols, blocks):
        yield cl, block[block[:, -1] > 0][:, :-1]


def host_rows(seconds: np.ndarray, scores: np.ndarray,
              unct: Optional[np.ndarray], act: Optional[np.ndarray],
              cls_cols: Sequence[int], floor: float, gate: bool,
              sigma: float, top_k: int, nms_floor: float = SCORE_FLOOR
              ) -> Rows:
    """(class, kept rows) of one video's candidates on the host: seconds
    (N, 2), scores (N, K), unct and act (N,) or None; classes with no
    candidate over the floor are skipped."""
    for cl in cls_cols:
        mask = scores[:, cl] > floor
        if gate:
            mask &= act > ACT_GATE
        if not mask.any():
            continue
        cols = [seconds[mask], scores[mask, cl][:, None]]
        cols += [e[mask][:, None] for e in (unct, act) if e is not None]
        with profiling.span('post.soft_nms'):
            kept, _ = soft_nms_numpy(np.concatenate(cols, axis=1),
                                     sigma=sigma, top_k=top_k,
                                     score_threshold=nms_floor)
        yield cl, kept


def proposals(rows: Rows, use_edl: bool, os_head: bool,
              duration: Optional[float] = None) -> List[Dict[str, Any]]:
    """Proposal dicts of each class's kept rows, rows scoring 0 or less
    dropped: 'cls' (the class column, + 1 under os_head), 'score',
    'segment' [start, end] in seconds, 'uncertainty' (row[3] with EDL),
    'actionness' (the last column under os_head; else 0.0 each). With
    a `duration` the segments are clamped to [0, duration] and empty
    ones dropped (anet/test.py:183-190)."""
    out: List[Dict[str, Any]] = []
    for cl, kept in rows:
        cls = int(cl + 1 if os_head else cl)
        for row in kept[~(kept[:, 2] <= 0)]:
            start, end = float(row[0]), float(row[1])
            if duration is not None:
                start, end = max(0.0, start), min(duration, end)
                if end <= start:
                    continue
            out.append({
                'cls': cls,
                'score': float(row[2]),
                'segment': [start, end],
                'uncertainty': float(row[3]) if use_edl else 0.0,
                'actionness': float(row[-1]) if os_head else 0.0,
            })
    return out
