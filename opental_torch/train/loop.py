"""Epoch training loop.

Counterpart of `opental_tpu/train/loop.py:33-241` (reference __main__ of
AFSD/thumos14/train.py:306-363): builds the model, losses, optimizer and
dataset from a Config, runs steps under the EDL epoch schedule, logs
metrics, and checkpoints every epoch after epoch 10 (train.py:290-292),
with resume; data-parallel over a mesh with `training.use_mesh`. Runs
on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional, Union

import torch

from opental_torch import factory, resolve_device
from opental_torch.config import Config
from opental_torch.data.anet import AnetTrainDataset
from opental_torch.data.prefetch import prefetch
from opental_torch.data.thumos import (ThumosTrainDataset, get_video_anno,
                                       get_video_info)
from opental_torch.losses.edl import EDLState
from opental_torch.parallel.mesh import (Mesh, make_mesh, shard_batch,
                                         shard_rows)
from opental_torch.train import checkpoint as ckpt
from opental_torch.train.step import (TrainState, make_anet_optimizer,
                                      make_data_parallel, make_optimizer,
                                      train_step)

SAVE_AFTER_EPOCH = 10


class MetricsLogger:
    """JSONL metrics stream, one record per step (`metrics.jsonl` in the
    checkpoint directory); the reference logs split 0 only."""

    def __init__(self, workdir: str, enabled: bool = True):
        self.enabled = enabled
        self.path = os.path.join(workdir, 'metrics.jsonl')
        self._f = None
        if enabled:
            os.makedirs(workdir, exist_ok=True)
            self._f = open(self.path, 'a')

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        if self._f is None:
            return
        rec = {'step': step}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._f.write(json.dumps(rec) + '\n')
        self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


def load_backbone(model: torch.nn.Module, path: str) -> None:
    """Overlay the pretrained I3D checkpoint (reference `rgb_imagenet.pt`,
    thumos14/BDNet.py:448-452) onto the backbone; keys the backbone lacks
    (the logits layer) are dropped, a backbone key it lacks raises."""
    sd = torch.load(path, map_location='cpu', weights_only=True)
    target = model.backbone._model
    want = target.state_dict()
    missing = sorted(set(want) - set(sd))
    if missing:
        raise KeyError(f'{path} lacks backbone keys {missing[:5]}...')
    target.load_state_dict({k: sd[k] for k in want}, strict=True)


def init_state(cfg: Config, device: torch.device, seed: int,
               frame_num: Optional[int] = None,
               crop_size: Optional[int] = None) -> TrainState:
    """Model with seeded glorot weights (the reference's reset_params; an
    ANet model's heads re-initialized on top), the I3D backbone overlaid
    when its file exists, Adam (ANet: the backbone at 0.1 x the heads'
    learning rate) and a fresh EDL state, all on `device`."""
    model = factory.init_train_weights(
        factory.build_model(cfg, frame_num=frame_num, crop_size=crop_size),
        seed=seed)
    backbone_path = cfg.get_path('model.backbone_model')
    if backbone_path and os.path.exists(backbone_path):
        load_backbone(model, backbone_path)
    elif backbone_path:
        print(f'backbone {backbone_path} not found: training from the '
              'seeded weights')
    model = model.to(device)
    tr = cfg.training
    loss_cfg = factory.build_loss_config(cfg)
    make_opt = make_anet_optimizer if model.arch == 'anet' \
        else make_optimizer
    return TrainState(
        model=model,
        optimizer=make_opt(model, tr['learning_rate'], tr['weight_decay']),
        edl_state=(EDLState.create(loss_cfg.edl, device)
                   if loss_cfg.edl is not None else None))


def build_dataset(cfg: Config, arch: str, clip_length: int, crop_size: int,
                  seed: int):
    """The training dataset of the config's arch (`train/loop.py:133-148`
    of the JAX package)."""
    uint8_ingest = bool(cfg.training.get('uint8_ingest', False))
    if arch == 'anet':
        return AnetTrainDataset(
            cfg.get_path('dataset.training.video_info_path'),
            cfg.get_path('dataset.training.video_data_path'),
            clip_length=clip_length, crop_size=crop_size, seed=seed,
            binary_class=cfg.get_path('dataset.binary_class', False),
            uint8_ingest=uint8_ingest)
    video_infos = get_video_info(
        cfg.get_path('dataset.training.video_info_path'))
    video_annos = get_video_anno(
        video_infos, cfg.get_path('dataset.training.video_anno_path'),
        cfg.get_path('dataset.class_info_path'))
    return ThumosTrainDataset(
        cfg.get_path('dataset.training.video_data_path'), video_infos,
        video_annos, clip_length=clip_length, crop_size=crop_size,
        stride=cfg.get_path('dataset.training.clip_stride', 30), seed=seed,
        uint8_ingest=uint8_ingest)


def train(cfg: Config, max_steps_per_epoch: Optional[int] = None,
          device: Optional[Union[str, torch.device]] = None,
          log_every: int = 20, prefetch_depth: int = 2) -> TrainState:
    """Full training run from a reference-schema Config, on the card
    unless device='cpu'. Batches are assembled and copied to the device
    `prefetch_depth` steps ahead on a background thread; metrics are read
    back every `log_every` steps, so the loop does not wait on the card
    after every step. `training.resume`: an epoch to resume from, -1 for
    the newest checkpoint, 0 to start afresh.

    `training.use_mesh` (the CLI's --use_mesh) trains data-parallel on
    the mesh of `parallel.mesh.make_mesh` (torchrun's ranks, one card
    each; or the process group already initialized): every rank builds
    the same state and dataset from the seed, draws the same global
    batch of `training.batch_size` rows (divisible by the mesh size) and
    keeps its rows; the step's loss and gradient are the global batch's
    (`train.step.make_data_parallel`). Every rank restores a
    checkpoint; rank 0 alone logs and writes them."""
    tr = cfg.training
    mesh = None
    if tr.get('use_mesh', False):
        mesh = make_mesh(device=device)
        dev = mesh.device
    else:
        dev = resolve_device(device)
    try:
        return _train(cfg, dev, mesh, max_steps_per_epoch, log_every,
                      prefetch_depth)
    finally:
        if mesh is not None:
            mesh.close()


def _train(cfg: Config, dev: torch.device, mesh: Optional[Mesh],
           max_steps_per_epoch: Optional[int], log_every: int,
           prefetch_depth: int) -> TrainState:
    tr = cfg.training
    clip_length = cfg.get_path('dataset.training.clip_length', 256)
    crop_size = cfg.get_path('dataset.training.crop_size', 96)
    batch_size = tr.get('batch_size', 1)
    if mesh is not None:
        shard_rows(mesh, batch_size)     # the global batch must divide
    lead = mesh is None or mesh.rank == 0
    seed = tr.get('random_seed', 2020)
    torch.manual_seed(seed)

    state = init_state(cfg, dev, seed, clip_length, crop_size)
    loss_cfg = factory.build_loss_config(cfg)
    weights = factory.build_loss_weights(cfg)
    dataset = build_dataset(cfg, state.model.arch, clip_length, crop_size,
                            seed)

    checkpoint_path = tr.get('checkpoint_path', './checkpoints')
    resume = tr.get('resume', 0)
    if resume == -1:
        latest = ckpt.latest_epoch(checkpoint_path)
        resume = latest if latest is not None else 0
    start_epoch = 1
    if resume and resume > 0:
        start_epoch = ckpt.restore(checkpoint_path, resume, state,
                                   dataset.rng) + 1
    if mesh is not None:
        make_data_parallel(state, mesh)

    def global_batches():
        for batch in dataset.batches(batch_size):
            yield batch if mesh is None else shard_batch(mesh, batch)

    logger = MetricsLogger(checkpoint_path,
                           enabled=lead and cfg.get_path('testing.split',
                                                         0) == 0)
    try:
        for epoch in range(start_epoch, tr.get('max_epoch', 25) + 1):
            t0 = time.time()
            sums: Dict[str, float] = {}
            pending = []        # (step, device metrics), read in bulk
            n_steps = 0

            def flush():
                for step, metrics in pending:
                    host = {k: float(v) for k, v in metrics.items()}
                    logger.log(step, host)
                    for k, v in host.items():
                        sums[k] = sums.get(k, 0.0) + v
                pending.clear()

            for batch in prefetch(global_batches(), dev,
                                  depth=prefetch_depth):
                metrics = train_step(state, loss_cfg, weights, batch, epoch)
                n_steps += 1
                pending.append((state.step, metrics))
                if len(pending) >= max(1, log_every):
                    flush()
                if max_steps_per_epoch and n_steps >= max_steps_per_epoch:
                    break
            flush()
            if not lead:
                continue
            means = {k: v / max(n_steps, 1) for k, v in sums.items()}
            print(f'Epoch-{epoch} Train Loss: Total - '
                  f'{means.get("cost", 0):.5f}'
                  f', loc - {means.get("loss_l", 0):.5f}'
                  f', conf - {means.get("loss_c", 0):.5f}'
                  f', prop_loc - {means.get("loss_prop_l", 0):.5f}'
                  f', prop_conf - {means.get("loss_prop_c", 0):.5f}'
                  f', IoU - {means.get("loss_ct", 0):.5f}'
                  f', start - {means.get("loss_start", 0):.5f}'
                  f', end - {means.get("loss_end", 0):.5f}'
                  f' [{time.time() - t0:.1f}s]', flush=True)
            if epoch > SAVE_AFTER_EPOCH:
                ckpt.save(checkpoint_path, epoch, state, dataset.rng)
    finally:
        logger.close()
    return state
