"""One training step: forward, the full loss, backward and the Adam update.

Counterpart of `opental_tpu/train/step.py:26-243` (reference train loop
body, AFSD/thumos14/train.py:164-252). The main and SSL passes run one
after the other through the model in train mode, as the reference does
(train.py:222-241): with `model.freeze_bn: false` each pass normalizes by
its own batch statistics and EMA-updates the running ones. With
`fuse_ssl` (off by default, as in the JAX step) and BN frozen, one pass
over the 2B batch computes both (`BDNet.train_forward`). The SSL
triplet loss is gated by the mean of the batch's augmentation flags. The
step updates the model, the optimizer and the EDL state in place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from opental_torch.losses.anet_multisegment import anet_multisegment_loss
from opental_torch.losses.boundary import boundary_losses, ssl_triplet_loss
from opental_torch.losses.edl import EDLState
from opental_torch.losses.multisegment import LossConfig, multisegment_loss

SSL_SCALE_WEIGHTS = (1.0, 0.1, 0.1)


class LossWeights(NamedTuple):
    """Scalar loss weights (reference argparse defaults,
    AFSD/common/config.py:23-28)."""
    lw: float = 1.0       # localization
    cw: float = 10.0      # classification
    ctw: float = 1.0      # centerness
    actw: float = 1.0     # actionness
    ssl: float = 0.1      # triplet


@dataclass
class TrainState:
    """What a step changes: the model's parameters and BN statistics, the
    optimizer's moments, the EDL bin state, and the step count."""
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    edl_state: Optional[EDLState] = None
    step: int = 0


def device_ingest(batch: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """Clips on the device into the model's input: uint8 [0, 255] ->
    float32 [-1, 1] in the host transform's op order
    (transforms.normalize_clip), and (B, T, H, W, C) -> (B, C, T, H, W).
    ANet uint8 batches carry (B, T) `pad_masks` / `ssl_pad_masks`: the
    frames the f32 path pads with 127.5, which normalizes to exactly 0.0,
    become where(pad, 0, x) (`opental_tpu/train/step.py:48-62`); the mask
    keys are consumed here."""
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
            out[k] = x.permute(0, 4, 1, 2, 3).contiguous()
    return out


def make_optimizer(model: torch.nn.Module, learning_rate: float,
                   weight_decay: float) -> torch.optim.Adam:
    """torch Adam with weight decay added to the gradient before the
    moments (not AdamW), betas (0.9, 0.999), eps 1e-8
    (thumos14/train.py:321-323)."""
    return torch.optim.Adam(model.parameters(), lr=learning_rate,
                            betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)


ANET_BACKBONE_LR_SCALE = 0.1


def make_anet_optimizer(model: torch.nn.Module, learning_rate: float,
                        weight_decay: float) -> torch.optim.Adam:
    """The ANet optimizer: `make_optimizer`'s Adam with two parameter
    groups, the heads at learning_rate and the backbone at
    learning_rate * ANET_BACKBONE_LR_SCALE (anet/train.py:304-311)."""
    groups = {True: [], False: []}
    for name, p in model.named_parameters():
        groups[name.startswith('backbone.')].append(p)
    return torch.optim.Adam(
        [{'params': groups[False], 'lr': learning_rate},
         {'params': groups[True],
          'lr': learning_rate * ANET_BACKBONE_LR_SCALE}],
        lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=weight_decay)


def compute_losses(model: torch.nn.Module, loss_cfg: LossConfig,
                   weights: LossWeights, batch: Dict[str, torch.Tensor],
                   edl_state: Optional[EDLState], epoch: int,
                   fuse_ssl: bool = False
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                              Optional[EDLState]]:
    """Full training objective (train.py:222-241) on an ingested batch:
    clips (B, C, T, H, W), truths (B, N, 2), labels (B, N), gt_mask (B, N),
    scores (B, 2, T) (ANet: (B, 3, T)), ssl_clips, ssl_props (B, 3, 2), ssl_flags (B,).
    Returns (cost, loss terms, new EDL state).

    fuse_ssl runs the main and SSL passes as one (`train_forward`), as
    the JAX rule allows it (`opental_tpu/train/step.py:130-131`): only
    while BN is frozen (with `model.freeze_bn: false` each pass draws its
    own batch statistics), the SSL weight is positive and the batch has
    SSL clips; otherwise the passes run one after the other."""
    use_ssl = weights.ssl > 0 and 'ssl_clips' in batch
    fused_trip = None
    if fuse_ssl and use_ssl and getattr(model, 'freeze_bn', True):
        out, fused_trip = model.train_forward(
            batch['clips'], batch['ssl_clips'], batch['ssl_props'])
    else:
        out = model(batch['clips'])
    if loss_cfg.variant == 'anet':
        losses, new_edl = anet_multisegment_loss(
            loss_cfg, out, batch['truths'], batch['labels'],
            batch['gt_mask'], edl_state=edl_state, epoch=epoch)
        # ANet heatmaps carry (action, start, end) rows; the proposal-level
        # targets subsample at the stride-8 feature rate
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
    if use_ssl:
        anchors, positives, negatives = (
            fused_trip if fused_trip is not None else model.ssl_forward(
                batch['ssl_clips'], batch['ssl_props']))
        # the reference gates by the augmentation's success flag
        # (train.py:237); a batch weighs by its flagged fraction
        flag = batch['ssl_flags'].float().mean()
        loss_trip = ssl_triplet_loss(anchors, positives, negatives,
                                     SSL_SCALE_WEIGHTS) * flag
        cost = cost + weights.ssl * loss_trip

    metrics = dict(losses)
    metrics.update({'loss_start': loss_start, 'loss_end': loss_end,
                    'loss_trip': loss_trip, 'cost': cost})
    return cost, metrics, new_edl


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


def train_step(state: TrainState, loss_cfg: LossConfig,
               weights: LossWeights, batch: Dict[str, torch.Tensor],
               epoch: int, fuse_ssl: bool = False
               ) -> Dict[str, torch.Tensor]:
    """One optimizer step on a batch already on the model's device.
    Updates `state` in place and returns the detached metrics (loss terms,
    cost, grad_norm) as device tensors: reading them is the caller's
    synchronisation. fuse_ssl: as `compute_losses`."""
    model = state.model
    model.train()
    batch = device_ingest(batch)
    state.optimizer.zero_grad(set_to_none=True)
    cost, metrics, new_edl = compute_losses(model, loss_cfg, weights, batch,
                                            state.edl_state, epoch,
                                            fuse_ssl=fuse_ssl)
    cost.backward()
    for p in model.parameters():
        if p.grad is None:
            # a parameter off this step's graph still takes weight decay,
            # as the JAX step's zero gradient does
            p.grad = torch.zeros_like(p)
    metrics['grad_norm'] = global_norm(p.grad for p in model.parameters())
    state.optimizer.step()
    state.edl_state = new_edl
    state.step += 1
    return {k: v.detach() for k, v in metrics.items()}
