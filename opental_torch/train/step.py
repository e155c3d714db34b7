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
from torch.nn.parallel import DistributedDataParallel

from opental_torch.losses.anet_multisegment import anet_multisegment_loss
from opental_torch.losses.boundary import boundary_losses, ssl_triplet_loss
from opental_torch.losses.edl import EDLState
from opental_torch.losses.multisegment import LossConfig, multisegment_loss
from opental_torch.models import layers
from opental_torch.models.bdnet import UNBATCHED_OUTPUTS
from opental_torch.parallel.mesh import Mesh, gather_rows, replicate
from opental_torch.utils import profiling

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
    mesh: Optional[Mesh] = None       # set by `make_data_parallel`
    ddp: Optional[torch.nn.Module] = None


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


class TrainPasses(torch.nn.Module):
    """The model's training passes as one `forward`: the main pass, and
    the SSL pass when `ssl_clips` is given (fused with the main one when
    `fuse`). DDP wraps this module, so that one DDP forward covers both
    passes of a step: its hooks see only `forward`, and `ssl_forward`
    called beside it would escape them.

    `forward` returns (the out_dict's batched entries, the SSL triplets
    or None) and keeps the model's shared entries (`UNBATCHED_OUTPUTS`:
    the priors, the RPL centers and radius, its own buffers and
    parameters) in `self.shared`: DDP takes a parameter among a forward's
    outputs for one the backward reaches, which GCPL's unused radius
    never is."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model
        self.shared: Dict[str, torch.Tensor] = {}

    def forward(self, clips: torch.Tensor,
                ssl_clips: Optional[torch.Tensor] = None,
                ssl_props: Optional[torch.Tensor] = None,
                fuse: bool = False):
        model = self.model
        if ssl_clips is None:
            out, trip = model(clips), None
        elif fuse and getattr(model, 'freeze_bn', True):
            out, trip = model.train_forward(clips, ssl_clips, ssl_props)
        else:
            out, trip = model(clips), model.ssl_forward(ssl_clips,
                                                        ssl_props)
        self.shared = {k: out.pop(k) for k in UNBATCHED_OUTPUTS if k in out}
        return out, trip


def run_passes(passes: torch.nn.Module, weights: LossWeights,
               batch: Dict[str, torch.Tensor], fuse_ssl: bool = False):
    """(the out_dict's batched entries, SSL triplets or None) of an
    ingested batch through `TrainPasses` or DDP around it."""
    if weights.ssl > 0 and 'ssl_clips' in batch:
        return passes(batch['clips'], batch['ssl_clips'],
                      batch['ssl_props'], fuse=fuse_ssl)
    return passes(batch['clips'])


def losses_of_outputs(loss_cfg: LossConfig, weights: LossWeights,
                      out: Dict[str, torch.Tensor], trip,
                      batch: Dict[str, torch.Tensor],
                      edl_state: Optional[EDLState], epoch: int
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                                 Optional[EDLState]]:
    """The training objective (train.py:222-241) of the model's outputs
    on the batch's targets: truths (B, N, 2), labels (B, N), gt_mask
    (B, N), scores (B, 2, T) (ANet: (B, 3, T)), ssl_flags (B,); `trip`
    the SSL triplet features or None. Returns (cost, loss terms, new EDL
    state)."""
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
    if trip is not None:
        anchors, positives, negatives = trip
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


def compute_losses(model: torch.nn.Module, loss_cfg: LossConfig,
                   weights: LossWeights, batch: Dict[str, torch.Tensor],
                   edl_state: Optional[EDLState], epoch: int,
                   fuse_ssl: bool = False
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                              Optional[EDLState]]:
    """Full training objective (train.py:222-241) on an ingested batch:
    clips (B, C, T, H, W), the targets of `losses_of_outputs`, ssl_clips,
    ssl_props (B, 3, 2). Returns (cost, loss terms, new EDL state).

    fuse_ssl runs the main and SSL passes as one (`train_forward`), as
    the JAX rule allows it (`opental_tpu/train/step.py:130-131`): only
    while BN is frozen (with `model.freeze_bn: false` each pass draws its
    own batch statistics), the SSL weight is positive and the batch has
    SSL clips; otherwise the passes run one after the other."""
    passes = TrainPasses(model)
    out, trip = run_passes(passes, weights, batch, fuse_ssl)
    return losses_of_outputs(loss_cfg, weights, dict(out, **passes.shared),
                             trip, batch, edl_state, epoch)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


MODEL_INPUTS = ('clips', 'ssl_clips', 'ssl_props')


def make_data_parallel(state: TrainState, mesh: Mesh) -> TrainState:
    """Put the state on the data mesh: rank 0's weights (parameters and
    buffers, `replicate`) on every rank, and `TrainPasses` of the model
    in DDP, after which `train_step` runs the mesh step. The broadcast
    is `replicate`'s alone (`init_sync` off): DDP's own would copy the
    parameters again and, with `broadcast_buffers` off, not the buffers
    (the frozen BN scales and biases among them). `broadcast_buffers` is
    off: the BN statistics agree by construction (`global_batch_stats`).
    `static_graph` is on: a step's set of parameters is fixed by the
    config, but some are off the graph (GCPL's RPL radius) and some are
    read outside the forward too (RPL's radius and centers, by the
    loss), which `find_unused_parameters`' search from the outputs cannot
    see; a static graph learns the set from the first step's gradients.
    A parameter off the graph keeps no gradient and takes weight decay on
    a zero one, as in `train_step`."""
    replicate(mesh, state.model)
    dev = mesh.device
    state.ddp = DistributedDataParallel(
        TrainPasses(state.model),
        device_ids=[dev] if dev.type == 'cuda' else None,
        process_group=mesh.group, broadcast_buffers=False,
        static_graph=True, init_sync=False)
    state.mesh = mesh
    return state


def _global_batch(mesh: Optional[Mesh], out: Dict[str, torch.Tensor],
                  trip, batch: Dict[str, torch.Tensor]):
    """The out_dict, SSL triplets and targets of the global batch: every
    batched output and target gathered in rank order (as they are
    without a mesh)."""
    if mesh is None:
        return out, trip, batch
    out = {k: gather_rows(mesh, v) if isinstance(v, torch.Tensor) else v
           for k, v in out.items()}
    if trip is not None:
        trip = tuple([gather_rows(mesh, t) for t in part] for part in trip)
    batch = {k: (v if k in MODEL_INPUTS else gather_rows(mesh, v))
             for k, v in batch.items()}
    return out, trip, batch


def _step_losses(state: TrainState, loss_cfg: LossConfig,
                 weights: LossWeights, batch: Dict[str, torch.Tensor],
                 epoch: int, fuse_ssl: bool):
    """(loss terms, new EDL state), the backward done. On a mesh each rank
    runs its rows through DDP, gathers the outputs and the targets, and
    takes the same loss of the global batch as one device would (the
    normalizers, the PU max, the MIB histogram, ANet's sample loop and
    the SSL flag mean are all global); the gather's backward leaves W x
    each rank's share of the gradient, and DDP's mean over the W ranks
    makes it the global batch's gradient."""
    passes = state.ddp or TrainPasses(state.model)
    module = getattr(passes, 'module', passes)      # inside DDP or not
    with layers.global_batch_stats(state.mesh):
        with profiling.span('step.forward'):
            out, trip, targets = _global_batch(
                state.mesh, *run_passes(passes, weights, batch, fuse_ssl),
                batch)
        with profiling.span('step.loss'):
            cost, metrics, new_edl = losses_of_outputs(
                loss_cfg, weights, dict(out, **module.shared), trip,
                targets, state.edl_state, epoch)
        with profiling.span('step.backward'):
            cost.backward()
    return metrics, new_edl


def train_step(state: TrainState, loss_cfg: LossConfig,
               weights: LossWeights, batch: Dict[str, torch.Tensor],
               epoch: int, fuse_ssl: bool = False
               ) -> Dict[str, torch.Tensor]:
    """One optimizer step on a batch already on the model's device (on a
    mesh, `make_data_parallel`: this rank's rows of the global batch).
    Updates `state` in place and returns the detached metrics (loss
    terms, cost, grad_norm; on a mesh those of the global batch, equal
    on every rank) as device tensors: reading them is the caller's
    synchronisation. fuse_ssl: as `compute_losses`. Spans: `step` (its
    request id the step count), with `step.ingest`, `step.forward`,
    `step.loss`, `step.backward` and `step.optimizer` inside."""
    with profiling.span('step', state.step):
        model = state.model
        model.train()
        with profiling.span('step.ingest'):
            batch = device_ingest(batch)
        state.optimizer.zero_grad(set_to_none=True)
        metrics, new_edl = _step_losses(state, loss_cfg, weights, batch,
                                        epoch, fuse_ssl)
        with profiling.span('step.optimizer'):
            for p in model.parameters():
                if p.grad is None:
                    # a parameter off this step's graph still takes weight
                    # decay, as the JAX step's zero gradient does
                    p.grad = torch.zeros_like(p)
            # read after DDP's reduction: the global gradient's norm on
            # every rank
            metrics['grad_norm'] = global_norm(p.grad
                                               for p in model.parameters())
            state.optimizer.step()
        state.edl_state = new_edl
        state.step += 1
        return {k: v.detach() for k, v in metrics.items()}
