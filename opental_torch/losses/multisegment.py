"""Batched GT matching and the multi-part detection loss.

Counterpart of `opental_tpu/losses/multisegment.py:26-254` (reference
MultiSegmentLoss, AFSD/thumos14/multisegment_loss.py:70-259): matching is
a fixed-shape (B, P, N_max) computation over padded GT tensors, and each
"gather the positives" is a masked sum, with the reference's
normalization N = max(#pos, 1). The classification term is focal, EDL
or RPL / GCPL (`cls_type`).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from opental_torch.losses.cls import (actionness_loss, bce_with_logits,
                                      focal_loss, rpl_loss)
from opental_torch.losses.edl import (EDLConfig, EDLState, evidence_loss,
                                      iou_calibration)

F32_EPS = float(torch.finfo(torch.float32).eps)


class LossConfig(NamedTuple):
    """Static configuration of the detection loss."""
    num_classes: int              # head classes (no background if os)
    clip_length: int = 256
    piou: float = 0.5             # refined-stage IoU threshold
    cls_type: str = 'edl'         # 'focal' | 'edl' | 'rpl'
    edl: Optional[EDLConfig] = None
    os_head: bool = False
    act_margin: float = 1.0
    act_weight: float = 0.1       # rank-loss weight inside actionness
    rpl_weight_pl: float = 0.1
    rpl_temperature: float = 1.0
    rpl_gcpl: bool = False
    focal_alpha: float = 0.25
    size_average: bool = False
    variant: str = 'thumos'       # 'thumos' | 'anet' matching/normalization


def segment_iou_1d(pred: torch.Tensor, target: torch.Tensor
                   ) -> torch.Tensor:
    """IoU of (left, right) offset pairs; (..., 2) -> (...)."""
    inter = (torch.minimum(pred[..., 0], target[..., 0])
             + torch.minimum(pred[..., 1], target[..., 1]))
    union = (pred[..., 0] + pred[..., 1]
             + target[..., 0] + target[..., 1] - inter)
    return inter / union.clamp_min(F32_EPS)


def giou_loss_1d(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """1 - GIoU over offset pairs."""
    ious = segment_iou_1d(pred, target)
    enclose = (torch.maximum(pred[..., 0], target[..., 0])
               + torch.maximum(pred[..., 1], target[..., 1]))
    union = (pred[..., 0] + pred[..., 1]
             + target[..., 0] + target[..., 1]
             - torch.minimum(pred[..., 0], target[..., 0])
             - torch.minimum(pred[..., 1], target[..., 1]))
    return 1.0 - (ious - (enclose - union) / enclose.clamp_min(F32_EPS))


class MatchResult(NamedTuple):
    loc_t: torch.Tensor        # (B, P, 2) GT offsets
    conf_t: torch.Tensor       # (B, P) int coarse labels (0 = background)
    prop_loc_t: torch.Tensor   # (B, P, 2) refined regression targets
    prop_conf_t: torch.Tensor  # (B, P) int refined labels
    iou: torch.Tensor          # (B, P) coarse-decode IoU vs GT


@torch.no_grad()
def match_targets(priors: torch.Tensor, loc_data: torch.Tensor,
                  truths: torch.Tensor, labels: torch.Tensor,
                  gt_mask: torch.Tensor, clip_length: int, piou: float
                  ) -> MatchResult:
    """Each prior takes the smallest GT whose span holds its center
    (first one on ties), background otherwise (multisegment_loss.py:
    120-153). priors (P, 1) in [0, 1]; loc_data (B, P, 2); truths (B, N, 2)
    normalized; labels (B, N) int; gt_mask (B, N) bool."""
    maxn = 2.0 * clip_length
    center = priors[:, 0]                                   # (P,)
    left = (center[None, :, None] - truths[:, None, :, 0]) * clip_length
    right = (truths[:, None, :, 1] - center[None, :, None]) * clip_length
    area = left + right                                     # (B, P, N)
    invalid = (left < 0) | (right < 0) | ~gt_mask[:, None, :]
    area = torch.where(invalid, torch.full_like(area, maxn), area)
    best_area = area.amin(dim=2)
    best_idx = area.argmin(dim=2)                           # first min
    tr = torch.gather(truths, 1, best_idx[..., None].expand(-1, -1, 2))
    loc_t = torch.stack([(center[None] - tr[..., 0]) * clip_length,
                         (tr[..., 1] - center[None]) * clip_length], -1)
    lb = torch.gather(labels, 1, best_idx)
    conf = torch.where(best_area >= maxn, torch.zeros_like(lb),
                       lb).to(torch.int32)
    iou = segment_iou_1d(loc_data, loc_t)
    prop_conf = torch.where(iou < piou, torch.zeros_like(conf), conf)
    prop_w = loc_data[..., 0] + loc_data[..., 1]
    prop_loc_t = (loc_t - loc_data) / (0.5 * prop_w[..., None])
    return MatchResult(loc_t, conf, prop_loc_t, prop_conf, iou)


def multisegment_loss(cfg: LossConfig, out: Dict[str, Any],
                      truths: torch.Tensor, labels: torch.Tensor,
                      gt_mask: torch.Tensor,
                      edl_state: Optional[EDLState] = None, epoch: int = 0
                      ) -> Tuple[Dict[str, torch.Tensor],
                                 Optional[EDLState]]:
    """Detection loss: ({loss_l, loss_c, loss_prop_l, loss_prop_c,
    loss_ct, loss_act, loss_prop_act}, new EDL state), each normalized as
    in multisegment_loss.py:243-254."""
    loc = out['loc']                     # (B, P, 2)
    conf = out['conf']                   # (B, P, K)
    prop_loc = out['prop_loc']
    prop_conf = out['prop_conf']
    center = out['center'][..., 0]       # (B, P)
    k = conf.shape[-1]

    m = match_targets(out['priors'], loc.detach(), truths, labels, gt_mask,
                      cfg.clip_length, cfg.piou)
    posf = (m.conf_t > 0).float()
    prop_posf = (m.prop_conf_t > 0).float()
    n_pos = posf.sum().clamp_min(1.0)
    n_prop_pos = prop_posf.sum().clamp_min(1.0)

    # coarse localization: GIoU over positives (:155-163)
    loss_l = (giou_loss_1d(loc, m.loc_t) * posf).sum()
    # refined localization: L1 on normalized offsets (:165-173)
    l1 = (prop_loc - m.prop_loc_t).abs().sum(dim=-1)
    loss_prop_l = (l1 * prop_posf).sum()

    # centerness: BCE(center logit, IoU of the refined decode) over coarse
    # positives (:175-189). The IoU target is NOT detached, as in the
    # reference: its gradient flows into loc, prop_loc and the ScaleExp
    # scales. The clamp at 0 passes the gradient at 0 (torch clamp_),
    # where a maximum would split it
    pre_w = (loc[..., 0] + loc[..., 1])[..., None]
    refined = 0.5 * pre_w * prop_loc + loc
    ious_raw = segment_iou_1d(refined, m.loc_t)
    ious_ct = torch.where(ious_raw >= 0, ious_raw,
                          torch.zeros_like(ious_raw))
    loss_ct = (bce_with_logits(center, ious_ct) * posf).sum()

    def stage_labels(conf_t):
        flat = conf_t.reshape(-1)
        if cfg.os_head:
            # positives only, labels shifted to start at 0 (:196-199)
            return (flat - 1).clamp_min(0), flat > 0
        return flat, torch.ones_like(flat, dtype=torch.bool)

    def cls_term(logits_flat, targets, valid, state, stage):
        if cfg.cls_type == 'focal':
            return focal_loss(torch.softmax(logits_flat, dim=1), targets,
                              valid, k, alpha=cfg.focal_alpha,
                              size_average=cfg.size_average), state
        if cfg.cls_type == 'edl':
            return evidence_loss(cfg.edl, logits_flat, targets, valid,
                                 state, epoch)
        if cfg.cls_type == 'rpl':
            # the refined stage takes the mean (reduction_mean), as the
            # JAX package's (multisegment.py:199-206)
            feats = out[stage + 'ctr_feat']
            return rpl_loss(logits_flat, targets, valid,
                            feats.reshape(-1, feats.shape[-1]),
                            out[stage + 'cls_ctr'], out['rpl_radius'][0],
                            temperature=cfg.rpl_temperature,
                            weight_pl=cfg.rpl_weight_pl, gcpl=cfg.rpl_gcpl,
                            size_average=cfg.size_average,
                            reduction_mean=stage == 'prop_'), state
        raise ValueError(cfg.cls_type)

    conf_flat = conf.reshape(-1, k)
    prop_conf_flat = prop_conf.reshape(-1, k)
    loss_c, state = cls_term(conf_flat, *stage_labels(m.conf_t), edl_state,
                             '')
    loss_prop_c, state = cls_term(prop_conf_flat,
                                  *stage_labels(m.prop_conf_t), state,
                                  'prop_')

    losses = {
        'loss_l': loss_l / n_pos,
        'loss_c': loss_c / n_pos,
        'loss_prop_l': loss_prop_l / n_prop_pos,
        'loss_prop_c': loss_prop_c / n_prop_pos,
        'loss_ct': loss_ct / n_pos,
    }
    # IoU-aware uncertainty calibration on all refined logits (:234-250)
    if cfg.cls_type == 'edl' and cfg.edl is not None and cfg.edl.iou_aware:
        losses['loss_prop_c'] = losses['loss_prop_c'] + iou_calibration(
            cfg.edl, prop_conf_flat, m.iou.reshape(-1), mean=True)

    # PU actionness (:210-213, 238-241)
    if cfg.os_head:
        act = out['act'][..., 0].reshape(-1)
        prop_act = out['prop_act'][..., 0].reshape(-1)
        all_valid = torch.ones_like(act, dtype=torch.bool)
        la, an = actionness_loss(act, (m.conf_t.reshape(-1) > 0).float(),
                                 all_valid, margin=cfg.act_margin,
                                 rank_weight=cfg.act_weight,
                                 size_average=cfg.size_average)
        lpa, pan = actionness_loss(
            prop_act, (m.prop_conf_t.reshape(-1) > 0).float(), all_valid,
            margin=cfg.act_margin, rank_weight=cfg.act_weight,
            size_average=cfg.size_average)
        losses['loss_act'] = la / an.clamp_min(1.0)
        losses['loss_prop_act'] = lpa / pan.clamp_min(1.0)
    else:
        zero = loc.new_zeros(())
        losses['loss_act'] = zero
        losses['loss_prop_act'] = zero
    return losses, state
