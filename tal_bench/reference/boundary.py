"""Frame-level boundary BCE and SSL triplet losses.

Counterpart of `opental_tpu/losses/boundary.py:18-72` (reference
AFSD/thumos14/train.py:152-201 and :177-184).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch


def _bce_prob(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """F.binary_cross_entropy semantics: direct logs clamped at -100."""
    floor = torch.full_like(x, -100.0)
    logx = torch.maximum(torch.log(x), floor)
    log1mx = torch.maximum(torch.log(1.0 - x), floor)
    return -(y * logx + (1.0 - y) * log1mx)


def boundary_bce(feat: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """mean BCE(tanh(feat).mean(channels), target); feat (B, T, C), target
    (B, T) in {0, 1}."""
    score = torch.tanh(feat).mean(dim=-1)
    return _bce_prob(score, target).mean()


def boundary_losses(out: Dict[str, torch.Tensor], scores: torch.Tensor,
                    start_row: int = 0, end_row: int = 1,
                    downscale: int = 4
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Frame-level plus proposal-level start / end losses. scores (B, R, T)
    GT heatmaps; the proposal-level targets are their stride-`downscale`
    subsample."""
    loss_start = boundary_bce(out['start'], scores[:, start_row])
    loss_end = boundary_bce(out['end'], scores[:, end_row])
    scores_q = scores[:, :, ::downscale]
    loss_start = loss_start + 0.1 * (
        boundary_bce(out['start_loc_prop'], scores_q[:, start_row])
        + boundary_bce(out['start_conf_prop'], scores_q[:, start_row]))
    loss_end = loss_end + 0.1 * (
        boundary_bce(out['end_loc_prop'], scores_q[:, end_row])
        + boundary_bce(out['end_conf_prop'], scores_q[:, end_row]))
    return loss_start, loss_end


def triplet_margin_loss(anchor: torch.Tensor, positive: torch.Tensor,
                        negative: torch.Tensor, margin: float = 1.0,
                        eps: float = 1e-6) -> torch.Tensor:
    """nn.TripletMarginLoss (p=2, mean reduction)."""
    def dist(a, b):
        return torch.sqrt(((a - b + eps) ** 2).sum(dim=-1))
    d = dist(anchor, positive) - dist(anchor, negative) + margin
    return torch.maximum(d, torch.zeros_like(d)).mean()


def ssl_triplet_loss(anchors: Sequence[torch.Tensor],
                     positives: Sequence[torch.Tensor],
                     negatives: Sequence[torch.Tensor],
                     weights: Sequence[float] = (1.0, 0.1, 0.1)
                     ) -> torch.Tensor:
    """Weighted sum over the three SSL feature scales."""
    total = 0.0
    for a, p, n, w in zip(anchors, positives, negatives, weights):
        total = total + w * triplet_margin_loss(a, p, n)
    return total
