"""Focal, positive-unlabeled actionness and reciprocal-point losses
(masked, fixed shape).

Counterpart of `opental_tpu/losses/cls.py` (reference FocalLoss_Ori,
ActionnessLoss and RPLoss / GCPLoss, AFSD/thumos14/cls_loss.py:6-78,
288-378).
"""

from __future__ import annotations

from typing import Tuple

import torch

FOCAL_EPS = 1e-6


def focal_loss(probs: torch.Tensor, target: torch.Tensor,
               valid: torch.Tensor, num_classes: int, alpha: float = 0.25,
               gamma: float = 2.0, balance_index: int = 0,
               size_average: bool = False) -> torch.Tensor:
    """Alpha-balanced focal loss over softmax scores, alpha on the
    background index. probs (N, K); target (N,) int; valid (N,) bool."""
    alpha_vec = torch.full((num_classes,), 1.0 - alpha, device=probs.device)
    alpha_vec[balance_index] = alpha
    pt = probs.gather(1, target[:, None].long())[:, 0] + FOCAL_EPS
    logpt = alpha_vec[target.long()] * torch.log(pt)
    per_row = -((1.0 - pt) ** gamma) * logpt
    validf = valid.to(per_row.dtype)
    total = (per_row * validf).sum()
    if size_average:
        return total / validf.sum().clamp_min(1.0)
    return total


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor
                    ) -> torch.Tensor:
    """Elementwise max(x, 0) - x y + log1p(exp(-|x|)) (the JAX form, with
    its gradient at x = 0)."""
    return (torch.maximum(logits, torch.zeros_like(logits))
            - logits * labels + torch.log1p(torch.exp(-logits.abs())))


def actionness_loss(logits: torch.Tensor, labels: torch.Tensor,
                    valid: torch.Tensor, margin: float = 1.0,
                    rank_weight: float = 0.1, size_average: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Positive-unlabeled actionness loss: BCE over the positives and the
    top-M lowest-score negatives (M = min(P, N) - 1), plus a margin rank
    loss against the noisiest negative. logits / labels / valid (N,).
    Returns (loss, normalizer count)."""
    pos = (labels > 0) & valid
    neg = (labels == 0) & valid
    posf, negf = pos.float(), neg.float()
    num_pos, num_neg = posf.sum(), negf.sum()
    top_m = torch.minimum(num_pos, num_neg) - 1.0

    # ascending rank of each negative among negatives (others last)
    neg_scores = torch.where(neg, logits.detach(),
                             torch.full_like(logits, float('inf')))
    order = torch.argsort(neg_scores, stable=True)
    ranks = torch.empty_like(order)
    ranks[order] = torch.arange(order.shape[0], device=order.device)
    clean_neg = neg & (ranks < top_m)

    use_topm = top_m > 0
    keep = torch.where(use_topm, (pos | clean_neg).float(), posf + negf)
    bce = bce_with_logits(logits, (labels > 0).float())
    if size_average:
        loss_bce = (bce * keep).sum() / keep.sum().clamp_min(1.0)
    else:
        loss_bce = (bce * keep).sum()

    # relu(margin - max(neg) + max(pos).detach()); finite sentinels keep
    # the unused branch's gradient finite
    sentinel = torch.full_like(logits, -1e9)
    neg_noisy = torch.where(neg, logits, sentinel).amax()
    pos_clean = torch.where(pos, logits, sentinel).amax().detach()
    zero = torch.zeros_like(neg_noisy)
    loss_rank = torch.where(
        use_topm, torch.maximum(zero, margin - neg_noisy + pos_clean), zero)

    count = torch.where(use_topm, num_pos + top_m, num_pos + num_neg)
    return loss_bce + rank_weight * loss_rank, count


def _masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          valid: torch.Tensor, mean: bool) -> torch.Tensor:
    nll = -torch.log_softmax(logits, dim=-1).gather(
        1, labels[:, None].long())[:, 0]
    validf = valid.to(nll.dtype)
    total = (nll * validf).sum()
    if mean:
        return total / validf.sum().clamp_min(1.0)
    return total


def rpl_loss(dist: torch.Tensor, target: torch.Tensor, valid: torch.Tensor,
             feats: torch.Tensor, centers: torch.Tensor,
             radius: torch.Tensor, temperature: float = 1.0,
             weight_pl: float = 0.1, gcpl: bool = False,
             size_average: bool = False, reduction_mean: bool = False
             ) -> torch.Tensor:
    """Reciprocal-point (RPL) or GCPL loss (cls_loss.py:355-378): cross
    entropy over the distances (negated for GCPL) plus weight_pl x a
    center term. dist (N, K) from RPLHead; target (N,) int; valid (N,)
    bool; feats (N, D) the head inputs; centers (K, D); radius the
    learnable scalar (RPL only)."""
    mean = size_average or reduction_mean
    center_batch = centers[target.long()]                  # (N, D)
    validf = valid.float()
    if gcpl:
        loss = _masked_cross_entropy(-dist / temperature, target, valid,
                                     mean)
        sq = ((feats - center_batch) ** 2).sum(dim=1) / feats.shape[1]
        # the reference's default-mean F.mse_loss over all elements / 2
        loss_r = (sq * validf).sum() / validf.sum().clamp_min(1.0) / 2.0
        return loss + weight_pl * loss_r
    loss = _masked_cross_entropy(dist / temperature, target, valid, mean)
    dis = ((feats - center_batch) ** 2).mean(dim=1)         # (N,)
    se = (dis - radius) ** 2
    if mean:
        loss_r = (se * validf).sum() / validf.sum().clamp_min(1.0)
    else:
        loss_r = (se * validf).sum()
    return loss + weight_pl * loss_r
