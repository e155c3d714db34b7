"""The plain training step: the model's two passes, the full loss, the
backward and a written-out Adam.

A frozen copy of the port's `train/step.py` semantics (reference
AFSD/thumos14/train.py:164-252): the main pass and the SSL pass run one
after the other through the model in train mode; the SSL triplet loss
is gated by the mean of the batch's augmentation flags; a parameter off
the step's graph takes a zero gradient; Adam adds the weight decay to
the gradient before the moments (not AdamW), betas (0.9, 0.999), eps
1e-8, and ActivityNet's backbone runs at 0.1 x the heads' rate.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from tal_bench.reference.anet_multisegment import anet_multisegment_loss
from tal_bench.reference.bdnet import UNBATCHED_OUTPUTS
from tal_bench.reference.boundary import boundary_losses, ssl_triplet_loss
from tal_bench.reference.edl import EDLState
from tal_bench.reference.multisegment import LossConfig, multisegment_loss

SSL_SCALE_WEIGHTS = (1.0, 0.1, 0.1)
ANET_BACKBONE_LR_SCALE = 0.1
BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


class LossWeights(NamedTuple):
    lw: float = 1.0
    cw: float = 10.0
    ctw: float = 1.0
    actw: float = 1.0
    ssl: float = 0.1


def ingest(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Clips into the model's input: uint8 [0, 255] -> float32 [-1, 1]
    ((x / 255) * 2 - 1, ANet's pad frames 0), and (B, T, H, W, C) ->
    (B, C, T, H, W)."""
    out = dict(batch)
    for k, mk in (('clips', 'pad_masks'), ('ssl_clips', 'ssl_pad_masks')):
        mask = out.pop(mk, None)
        if k in out:
            x = out[k]
            if x.dtype == torch.uint8:
                x = (x.float() / 255.0) * 2.0 - 1.0
                if mask is not None:
                    x = torch.where(mask.bool()[:, :, None, None, None],
                                    0.0, x)
            out[k] = x.float().permute(0, 4, 1, 2, 3).contiguous()
    return out


def losses_of_outputs(loss_cfg: LossConfig, weights: LossWeights,
                      out: Dict[str, torch.Tensor], trip,
                      batch: Dict[str, torch.Tensor],
                      edl_state: Optional[EDLState], epoch: int
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                                 Optional[EDLState]]:
    """(cost, loss terms, new EDL state) of the outputs on the targets."""
    if loss_cfg.variant == 'anet':
        losses, new_edl = anet_multisegment_loss(
            loss_cfg, out, batch['truths'], batch['labels'],
            batch['gt_mask'], edl_state=edl_state, epoch=epoch)
        loss_start, loss_end = boundary_losses(out, batch['scores'],
                                               start_row=1, end_row=2,
                                               downscale=8)
    else:
        losses, new_edl = multisegment_loss(
            loss_cfg, out, batch['truths'], batch['labels'],
            batch['gt_mask'], edl_state=edl_state, epoch=epoch)
        loss_start, loss_end = boundary_losses(out, batch['scores'])
    cost = (weights.lw * losses['loss_l'] + weights.cw * losses['loss_c']
            + weights.lw * losses['loss_prop_l']
            + weights.cw * losses['loss_prop_c']
            + weights.ctw * losses['loss_ct'] + loss_start + loss_end)
    if loss_cfg.os_head:
        cost = cost + weights.actw * (losses['loss_act']
                                      + losses['loss_prop_act'])
    loss_trip = cost.new_zeros(())
    if trip is not None:
        anchors, positives, negatives = trip
        flag = batch['ssl_flags'].float().mean()
        loss_trip = ssl_triplet_loss(anchors, positives, negatives,
                                     SSL_SCALE_WEIGHTS) * flag
        cost = cost + weights.ssl * loss_trip
    metrics = dict(losses)
    metrics.update({'loss_start': loss_start, 'loss_end': loss_end,
                    'loss_trip': loss_trip, 'cost': cost})
    return cost, metrics, new_edl


class Adam:
    """Adam with L2 weight decay on the gradient, per parameter group
    (a list of (parameters, learning rate)), written out."""

    def __init__(self, groups: List[Tuple[List[torch.Tensor], float]],
                 weight_decay: float):
        self.groups = groups
        self.weight_decay = weight_decay
        self.t = 0
        self.m = {id(p): torch.zeros_like(p) for ps, _ in groups for p in ps}
        self.v = {id(p): torch.zeros_like(p) for ps, _ in groups for p in ps}

    @torch.no_grad()
    def step(self) -> None:
        self.t += 1
        b1, b2 = BETAS
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for params, lr in self.groups:
            for p in params:
                g = p.grad + self.weight_decay * p
                m, v = self.m[id(p)], self.v[id(p)]
                m.mul_(b1).add_((1 - b1) * g)
                v.mul_(b2).add_((1 - b2) * g * g)
                denom = v.sqrt() / math.sqrt(c2) + ADAM_EPS
                p.sub_((lr / c1) * m / denom)


def make_adam(model: torch.nn.Module, learning_rate: float,
              weight_decay: float) -> Adam:
    """The configuration's optimizer: one group, or ActivityNet's two
    (the backbone at 0.1 x the heads' rate)."""
    if getattr(model, 'arch', 'thumos') != 'anet':
        return Adam([(list(model.parameters()), learning_rate)],
                    weight_decay)
    heads, backbone = [], []
    for name, p in model.named_parameters():
        (backbone if name.startswith('backbone.') else heads).append(p)
    return Adam([(heads, learning_rate),
                 (backbone, learning_rate * ANET_BACKBONE_LR_SCALE)],
                weight_decay)


def step(model: torch.nn.Module, adam: Adam, loss_cfg: LossConfig,
         weights: LossWeights, batch: Dict[str, Any],
         edl_state: Optional[EDLState], epoch: int
         ) -> Tuple[Dict[str, torch.Tensor], Optional[EDLState],
                    Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """One step in place. Returns (loss terms, new EDL state, the
    gradient of every parameter by name, as the optimizer got it before
    weight decay, the main pass's outputs)."""
    model.train()
    for p in model.parameters():
        p.grad = None
    batch = ingest(batch)
    out = model(batch['clips'])
    trip = None
    if weights.ssl > 0 and 'ssl_clips' in batch:
        trip = model.ssl_forward(batch['ssl_clips'], batch['ssl_props'])
    shared = {k: out.pop(k) for k in UNBATCHED_OUTPUTS if k in out}
    outputs = {k: v.detach() for k, v in out.items()
               if isinstance(v, torch.Tensor)}
    cost, metrics, new_edl = losses_of_outputs(
        loss_cfg, weights, dict(out, **shared), trip, batch, edl_state,
        epoch)
    cost.backward()
    grads = {}
    for name, p in model.named_parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads[name] = p.grad.detach().clone()
    adam.step()
    return ({k: v.detach() for k, v in metrics.items()}, new_edl, grads,
            outputs)


def lr_of(cfg_training: Dict[str, Any]) -> Tuple[float, float]:
    return (float(cfg_training['learning_rate']),
            float(cfg_training['weight_decay']))

