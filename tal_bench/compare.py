"""Comparisons that decide `correct`, shared by the runners."""

from __future__ import annotations

import math
import statistics
from typing import Dict, List

import torch


class exact_f32:
    """TF32 off for float32 convolutions and matrix products while open
    (the reference's precision); `tf32=True` turns it on instead."""

    def __init__(self, tf32: bool = False):
        self.tf32 = tf32

    def __enter__(self):
        self.prev = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        torch.backends.cudnn.allow_tf32 = self.tf32
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.prev


def rel_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]
            ) -> float:
    """The largest relative l2 gap, ||p - r|| / ||r||, over the tensors
    the reference has (infinite where one is missing or of another
    shape)."""
    worst = 0.0
    for k, r in ref.items():
        if k not in prog or prog[k].shape != r.shape:
            return math.inf
        p = prog[k].float().to(r.device)
        worst = max(worst, float((p - r.float()).norm()
                                 / r.float().norm().clamp_min(1e-30)))
    return worst


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(t.double().norm()) for k, t in tensors.items()}


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              leaves: List[str]) -> Dict[str, float]:
    """Each leaf's gap between the program's norm and the reference's,
    over the reference's norm of that leaf or of the median leaf,
    whichever is larger."""
    med = statistics.median(ref[k] for k in leaves)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
            for k in leaves}

