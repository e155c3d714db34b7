"""Plain post-processing of one video's decoded windows: seconds, the
per-class top-k preselect, greedy gaussian soft-NMS in NumPy, and the
proposal list (the semantics of the port's
`InferencePipeline.post_process_on_device`; reference softnms_v2,
AFSD/common/segment_utils.py:128-162)."""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from tal_bench.reference.decode import DecodedWindows

SCORE_FLOOR = 1e-3


def round_bf16(x: np.ndarray) -> np.ndarray:
    """x rounded to bfloat16, returned as float32."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def soft_nms_rows(seg: np.ndarray, valid: np.ndarray, sigma: float,
                  top_k: int, low: bool = False) -> np.ndarray:
    """Greedy soft-NMS of every row (class) of seg (C, N, D) [start, end,
    score, ...] at once; valid (C, N). Returns (C, N, D + 1): decayed
    scores and a picked flag. A row stops once it has one undone
    candidate left or top_k picks. `low` computes in bfloat16 (every
    input and every decayed score rounded to it): the control."""
    rnd = round_bf16 if low else (lambda a: a)
    seg = rnd(seg.astype(np.float32))
    c, n, _ = seg.shape
    start, end = seg[..., 0], seg[..., 1]
    scores = seg[..., 2].copy()
    length = end - start
    undone = (scores >= SCORE_FLOOR) & valid
    kept = np.zeros_like(undone)
    count = np.zeros(c, np.int64)
    rows = np.arange(c)
    for _ in range(min(n, top_k)):
        go = (undone.sum(1) > 1) & (count < top_k)
        if not go.any():
            break
        idx = np.where(undone, scores, -np.inf).argmax(1)
        pick = np.zeros_like(undone)
        pick[rows[go], idx[go]] = True
        undone &= ~pick
        kept |= pick
        s_i, e_i = start[rows, idx][:, None], end[rows, idx][:, None]
        inter = np.maximum(np.minimum(end, e_i) - np.maximum(start, s_i),
                           np.float32(0))
        width = np.maximum(e_i - s_i, np.float32(1e-5))
        with np.errstate(invalid='ignore', divide='ignore'):
            # a reversed segment can make this 0 / 0: NaN drops it, as
            # on the card
            iou = inter / (width + length - inter)
            decay = rnd(np.exp(-iou ** 2 / np.float32(sigma)).astype(
                np.float32))
        upd = undone & go[:, None]
        scores = np.where(upd, rnd(scores * decay), scores)
        undone &= scores >= SCORE_FLOOR
        count += go
    seg[..., 2] = scores
    return np.concatenate([seg, kept[..., None].astype(np.float32)], -1)


def proposals(dec: DecodedWindows, offsets: Sequence[int],
              sample_fps: float, num_classes: int, os_head: bool,
              use_edl: bool, conf_thresh: float, n_candidates: int,
              sigma: float, top_k: int, low: bool = False
              ) -> List[Dict[str, Any]]:
    """The video's proposals from its decoded windows (any device and
    dtype; seconds on their device, the rest on the host in float32).
    The score threshold is taken in the scores' dtype, as a comparison
    of a bfloat16 tensor with a number is. `low`: soft-NMS in bfloat16
    (the control)."""
    def host(t: Optional[torch.Tensor]) -> Optional[np.ndarray]:
        return None if t is None else t.float().cpu().numpy()

    thresh = np.float32(torch.tensor(conf_thresh,
                                     dtype=dec.scores.dtype).item())
    # the seconds in the program's own expression on the decoded rows'
    # device: the card divides by a number as a multiplication by its
    # reciprocal, and soft-NMS's IoU of a reversed segment can turn on
    # that last bit (0 / 0)
    off = torch.as_tensor(np.asarray(offsets, np.float32),
                          device=dec.segments.device)
    seconds = host(((dec.segments.float() + off[:, None, None])
                    / float(sample_fps)).reshape(-1, 2))
    scores = host(dec.scores)
    w, p = dec.segments.shape[:2]
    flat = scores.reshape(-1, scores.shape[-1])
    gate = np.ones(w * p, bool)
    extras = []
    if use_edl:
        extras.append(host(dec.uncertainty).reshape(-1))
    if os_head:
        a = host(dec.actionness).reshape(-1)
        gate &= a > 0.5
        extras.append(a)
    cls_cols = list(range(num_classes)) if os_head else \
        list(range(1, num_classes))
    k_eff = min(n_candidates, flat.shape[0])
    stacked = flat[:, cls_cols].T                              # (C, N)
    sc = np.where((stacked > thresh) & gate[None], stacked,
                  np.float32(0))
    order = np.argsort(-sc, axis=1, kind='stable')[:, :k_eff]
    top = np.take_along_axis(sc, order, 1)
    cols = [seconds[order], top[..., None]]
    cols += [e[order][..., None] for e in extras]
    blocks = soft_nms_rows(np.concatenate(cols, -1), top > 0, sigma, top_k,
                           low)
    out: List[Dict[str, Any]] = []
    for ci, cl in enumerate(cls_cols):
        kept = blocks[ci]
        kept = kept[(kept[:, -1] > 0) & (kept[:, 2] > 0)]
        for row in kept:
            out.append({
                'cls': int(cl + 1 if os_head else cl),
                'score': float(row[2]),
                'segment': [float(row[0]), float(row[1])],
                'uncertainty': float(row[3]) if use_edl else 0.0,
                'actionness': float(row[-2]) if os_head else 0.0})
    return out


MATCH_SECONDS = 1e-3    # a segment found in the other list
MATCH_FROM = 0.01       # proposals at or above this score must be found


def gap(program: List[Dict[str, Any]], reference: List[Dict[str, Any]]
        ) -> float:
    """The widest difference between two proposal lists of one video,
    class by class, robust to the order in which tied candidates were
    picked (which moves decays between them, and can let a candidate
    near the score floor drop on one side only):
    * the scores, both sorted, rank by rank (the shorter list padded
      with zeros): the largest gap;
    * every proposal scoring MATCH_FROM or more on one side has its
      segment (within MATCH_SECONDS) among the same class's on the other
      side, and its uncertainty and actionness within the score gap's
      scale: each one missing adds 1."""
    def by_class(ps):
        out: Dict[int, List[Dict[str, Any]]] = {}
        for q in ps:
            out.setdefault(q['cls'], []).append(q)
        return out

    def table(ps):
        return np.asarray([(q['segment'][0], q['segment'][1],
                            q['uncertainty'], q['actionness'], q['score'])
                           for q in ps], np.float64).reshape(-1, 5)

    def missing(x, y):
        if not len(x):
            return 0
        strong = x[x[:, 4] >= MATCH_FROM]
        if not len(strong):
            return 0
        if not len(y):
            return len(strong)
        d_seg = np.abs(strong[:, None, :2] - y[None, :, :2]).max(-1)
        d_ext = np.abs(strong[:, None, 2:4] - y[None, :, 2:4]).max(-1)
        found = ((d_seg <= MATCH_SECONDS) & (d_ext <= MATCH_SECONDS)
                 ).any(1)
        return int((~found).sum())

    a, b = by_class(program), by_class(reference)
    worst, misses = 0.0, 0
    for cl in set(a) | set(b):
        ta, tb = table(a.get(cl, [])), table(b.get(cl, []))
        n = max(len(ta), len(tb))
        sa = np.zeros(n)
        sb = np.zeros(n)
        sa[:len(ta)] = np.sort(ta[:, 4])[::-1]
        sb[:len(tb)] = np.sort(tb[:, 4])[::-1]
        worst = max(worst, float(np.abs(sa - sb).max(initial=0.0)))
        misses += missing(ta, tb) + missing(tb, ta)
    return worst + misses
