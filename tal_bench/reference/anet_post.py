"""Plain post-processing of ActivityNet videos, one 768-frame window
each: seconds, the per-class score floor and actionness gate, a top-k
preselect, greedy gaussian soft-NMS in NumPy (`post.soft_nms_rows`), and
the proposals clamped to the video's duration (the semantics of the
port's `tools/test_anet.build_device_post` and `AnetInference`;
reference AFSD/anet/test.py:130-239)."""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from tal_bench.reference.decode import DecodedWindows
from tal_bench.reference.post import soft_nms_rows

SCORE_FLOOR = 0.001     # anet/test.py:134, on float32 scores
ACT_GATE = 0.5          # anet/test.py:135


def proposals(dec: DecodedWindows, fps: float, duration: float,
              num_classes: int, os_head: bool, use_edl: bool,
              n_candidates: int, sigma: float, top_k: int,
              low: bool = False) -> List[Dict[str, Any]]:
    """One video's proposals from its decoded window (W = 1; any device
    and dtype; seconds on its device, the rest on the host in float32).
    `low`: soft-NMS in bfloat16 (the control)."""
    def host(t: torch.Tensor) -> np.ndarray:
        return t.float().cpu().numpy()

    # the seconds in the program's own expression on the decoded rows'
    # device: a division by a float32 tensor
    rate = torch.full((), np.float32(fps), dtype=torch.float32,
                      device=dec.segments.device)
    seconds = host(dec.segments[0].float() / rate)                # (P, 2)
    scores = host(dec.scores[0])                                  # (P, K)
    gate = np.ones(scores.shape[0], bool)
    extras = []
    if use_edl:
        extras.append(host(dec.uncertainty[0]))
    if os_head:
        act = host(dec.actionness[0])
        gate &= act > ACT_GATE
        extras.append(act)
    cls_cols = list(range(num_classes)) if os_head else \
        list(range(1, num_classes))
    k_eff = min(n_candidates, scores.shape[0])
    stacked = scores[:, cls_cols].T                               # (C, P)
    sc = np.where((stacked > np.float32(SCORE_FLOOR)) & gate[None], stacked,
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
        for row in kept[(kept[:, -1] > 0) & (kept[:, 2] > 0)]:
            start, end = max(0.0, float(row[0])), min(duration, float(row[1]))
            if end <= start:
                continue
            out.append({
                'cls': int(cl + 1 if os_head else cl),
                'score': float(row[2]),
                'segment': [start, end],
                'uncertainty': float(row[3]) if use_edl else 0.0,
                'actionness': float(row[-2]) if os_head else 0.0})
    return out
