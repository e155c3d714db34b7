"""ActivityNet multi-segment detection loss.

Counterpart of `opental_tpu/losses/anet_multisegment.py:46-176`
(reference AFSD/anet/multisegment_loss.py:86-301). It differs from the
THUMOS loss (`losses/multisegment.py`) in four places:
 * matching adds per-level regression ranges: a prior matches only a GT
   whose larger boundary distance lies in (lb, rb] of its pyramid level,
   read from priors[:, 1] (:151-166, bounds at :69);
 * the refined stage's IoU threshold adapts: min(piou, the largest IoU
   of a positive) (:178-184);
 * the refined localization is a smooth-L1 (:206);
 * every term is normalized per sample, then averaged over the batch
   (:268-301).
The samples run one after the other in batch order, as the JAX package's
`lax.scan` and the reference's per-sample calls do, so the EDL bin state
threads through them in that order.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from tal_bench.reference.cls import (actionness_loss, bce_with_logits,
                                      focal_loss)
from tal_bench.reference.edl import EDLState, evidence_loss, iou_calibration
from tal_bench.reference.multisegment import (LossConfig, giou_loss_1d,
                                               segment_iou_1d)
from tal_bench.reference.anet_pyramid import LEVEL_BOUNDS

TERMS = ('loss_l', 'loss_c', 'loss_prop_l', 'loss_prop_c', 'loss_ct',
         'loss_act', 'loss_prop_act')


def prior_bounds(priors: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-prior regression range (lb, rb) from the level index in
    priors[:, 1] (anet/multisegment_loss.py:73-84)."""
    bounds = torch.tensor(LEVEL_BOUNDS, dtype=torch.float32,
                          device=priors.device)[priors[:, 1].long()]
    return bounds[:, 0], bounds[:, 1]


def smooth_l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    d = (pred - target).abs()
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


def _sample_loss(cfg: LossConfig, priors: torch.Tensor, lb: torch.Tensor,
                 rb: torch.Tensor, loc: torch.Tensor, logits: torch.Tensor,
                 prop_loc: torch.Tensor, prop_logits: torch.Tensor,
                 center: torch.Tensor, act: Optional[torch.Tensor],
                 prop_act: Optional[torch.Tensor], truths: torch.Tensor,
                 labels: torch.Tensor, gt_mask: torch.Tensor,
                 state: Optional[EDLState], epoch: int
                 ) -> Tuple[torch.Tensor, Optional[EDLState]]:
    """The seven normalized terms of one sample (P priors, N GT slots),
    stacked, and the EDL state after its two classification terms."""
    clip = cfg.clip_length
    k = logits.shape[-1]
    centers = priors[:, 0]
    with torch.no_grad():
        left = (centers[:, None] - truths[None, :, 0]) * clip      # (P, N)
        right = (truths[None, :, 1] - centers[:, None]) * clip
        max_dis = torch.maximum(left, right)
        maxn = 2.0 * clip
        invalid = ((left < 0) | (right < 0) | ~gt_mask[None, :]
                   | (max_dis <= lb[:, None]) | (max_dis > rb[:, None]))
        area = torch.where(invalid, torch.full_like(left, maxn),
                           left + right)
        best_area, best_idx = area.min(dim=1)       # the first minimum
        tr = truths[best_idx]
        loc_t = torch.stack([(centers - tr[:, 0]) * clip,
                             (tr[:, 1] - centers) * clip], -1)
        conf_t = torch.where(best_area >= maxn, torch.zeros_like(best_idx),
                             labels[best_idx].long())
        loc_ng = loc.detach()
        iou = segment_iou_1d(loc_ng, loc_t)
        pos = conf_t > 0
        max_iou = (torch.where(pos, iou, float('-inf')).amax() if pos.any()
                   else iou.new_tensor(2.0))
        thr = torch.clamp(max_iou, max=cfg.piou)
        prop_conf_t = torch.where(iou < thr, torch.zeros_like(conf_t),
                                  conf_t)
        prop_w = loc_ng[:, 0] + loc_ng[:, 1]
        prop_loc_t = (loc_t - loc_ng) / (0.5 * prop_w[:, None])
    posf = pos.float()
    prop_posf = (prop_conf_t > 0).float()
    n = posf.sum().clamp_min(1.0)
    pn = prop_posf.sum().clamp_min(1.0)

    loss_l = (giou_loss_1d(loc, loc_t) * posf).sum()
    loss_prop_l = (smooth_l1(prop_loc, prop_loc_t).sum(-1) * prop_posf).sum()
    # the IoU target is NOT detached (anet/multisegment_loss.py:217-221):
    # its gradient flows into loc, prop_loc and the ScaleExp scales; the
    # clamp at 0 passes the gradient at 0, as torch's clamp_
    pre_w = (loc[:, 0] + loc[:, 1])[:, None]
    ious_raw = segment_iou_1d(0.5 * pre_w * prop_loc + loc, loc_t)
    ious_ct = torch.where(ious_raw >= 0, ious_raw, torch.zeros_like(ious_raw))
    loss_ct = (bce_with_logits(center, ious_ct) * posf).sum()

    def cls_term(logit, tgt, state_in):
        if cfg.os_head:
            valid, tgt = tgt > 0, (tgt - 1).clamp_min(0)
        else:
            valid = torch.ones_like(tgt, dtype=torch.bool)
        if cfg.cls_type == 'focal':
            return focal_loss(torch.softmax(logit, dim=1), tgt, valid, k,
                              alpha=cfg.focal_alpha), state_in
        if cfg.cls_type == 'edl':
            return evidence_loss(cfg.edl, logit, tgt, valid, state_in, epoch)
        raise NotImplementedError(f'cls_type {cfg.cls_type!r} is not '
                                  'ported yet')

    loss_c, state = cls_term(logits, conf_t, state)
    loss_prop_c, state = cls_term(prop_logits, prop_conf_t, state)
    loss_prop_c = loss_prop_c / pn
    if cfg.cls_type == 'edl' and cfg.edl is not None and cfg.edl.iou_aware:
        loss_prop_c = loss_prop_c + iou_calibration(cfg.edl, prop_logits,
                                                    iou, mean=True)
    if cfg.os_head:
        all_valid = torch.ones_like(posf, dtype=torch.bool)
        la, an = actionness_loss(act, posf, all_valid,
                                 margin=cfg.act_margin,
                                 rank_weight=cfg.act_weight)
        lpa, pan = actionness_loss(prop_act, prop_posf, all_valid,
                                   margin=cfg.act_margin,
                                   rank_weight=cfg.act_weight)
        loss_act, loss_prop_act = la / an.clamp_min(1.0), \
            lpa / pan.clamp_min(1.0)
    else:
        loss_act = loss_prop_act = loc.new_zeros(())
    return torch.stack([loss_l / n, loss_c / n, loss_prop_l / pn,
                        loss_prop_c, loss_ct / n, loss_act,
                        loss_prop_act]), state


def anet_multisegment_loss(cfg: LossConfig, out: Dict[str, Any],
                           truths: torch.Tensor, labels: torch.Tensor,
                           gt_mask: torch.Tensor,
                           edl_state: Optional[EDLState] = None,
                           epoch: int = 0
                           ) -> Tuple[Dict[str, torch.Tensor],
                                      Optional[EDLState]]:
    """Detection loss of a batch: ({loss_l, loss_c, loss_prop_l,
    loss_prop_c, loss_ct, loss_act, loss_prop_act}, each the batch mean of
    the per-sample normalized terms; the EDL state after the last
    sample). out has the model's (B, P, ...) layout with priors (P, 2);
    truths (B, N, 2) normalized, labels (B, N), gt_mask (B, N)."""
    priors = out['priors']
    lb, rb = prior_bounds(priors)
    rows, state = [], edl_state
    for i in range(out['conf'].shape[0]):
        row, state = _sample_loss(
            cfg, priors, lb, rb, out['loc'][i], out['conf'][i],
            out['prop_loc'][i], out['prop_conf'][i], out['center'][i, :, 0],
            out['act'][i, :, 0] if cfg.os_head else None,
            out['prop_act'][i, :, 0] if cfg.os_head else None,
            truths[i], labels[i], gt_mask[i], state, epoch)
        rows.append(row)
    mean = torch.stack(rows).mean(dim=0)
    return {name: mean[j] for j, name in enumerate(TERMS)}, state
