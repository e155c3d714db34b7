"""The data mesh on the card: a world of one over NCCL (DDP, the BN and
gather collectives, the pool kernels under DDP) equals the plain train
step with TF32 off (bit for bit where the plain step reproduces itself,
else within its own spread), and two ranks on the card(s) (NCCL with
a card each, gloo where they share one) equal one process within the
JAX mesh test's tolerances. This file imports neither JAX nor the JAX
package:

    python -m pytest --noconftest -m cuda tests/test_torch_mesh_cuda.py

Without a card its tests skip (a CUDA kernel has no CPU mode).
"""

import contextlib
import copy

import numpy as np
import pytest
import torch

from opental_torch import factory
from opental_torch.config import load_config
from opental_torch.losses.edl import EDLState
from opental_torch.ops import boundary_pool_cuda
from opental_torch.parallel.dryrun import (Ranks, assert_same_step,
                                           assert_world_one_step,
                                           step_record)
from opental_torch.parallel.mesh import make_mesh
from opental_torch.train.step import (TrainState, make_data_parallel,
                                      make_optimizer, train_step)
from opental_torch.utils.synthetic import tiny_train_batch

CONFIG = 'configs/thumos14_opental_final.yaml'
FRAMES, CROP, EPOCH = 128, 64, 11


def need_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernels have no CPU mode')


@contextlib.contextmanager
def tf32_off():
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = saved


def setup(freeze_bn=True):
    cfg = load_config(CONFIG, overrides={'model.freeze_bn': freeze_bn})
    model = factory.init_train_weights(factory.build_model(
        cfg, frame_num=FRAMES, crop_size=CROP, dtype=torch.float32), seed=0)
    return cfg, model


def state_on(cfg, model, device):
    model = copy.deepcopy(model).to(device)
    return TrainState(model=model, optimizer=make_optimizer(model, 1e-5,
                                                            1e-3),
                      edl_state=EDLState.create(
                          factory.build_loss_config(cfg).edl, device))


def step(cfg, state, batch):
    return train_step(state, factory.build_loss_config(cfg),
                      factory.build_loss_weights(cfg),
                      {k: torch.from_numpy(v).cuda()
                       for k, v in batch.items()}, EPOCH)


@pytest.mark.cuda
@pytest.mark.parametrize('freeze_bn', [True, False])
def test_world_of_one_over_nccl_equals_the_plain_step(freeze_bn):
    """Against two plain steps: bit for bit where the plain step
    reproduces itself, else within its own spread
    (`assert_world_one_step`)."""
    need_card()
    cfg, model = setup(freeze_bn)
    batch = tiny_train_batch(2, FRAMES, CROP, seed=3)
    mesh = make_mesh(world_size=1, rank=0, device='cuda')
    try:
        with tf32_off():
            want, again = (step_record(st, step(cfg, st, batch)) for st in
                           (state_on(cfg, model, 'cuda') for _ in range(2)))
            ddp = make_data_parallel(state_on(cfg, model, 'cuda'), mesh)
            before = (boundary_pool_cuda.LAUNCHES,
                      boundary_pool_cuda.BWD_LAUNCHES)
            got = step_record(ddp, step(cfg, ddp, batch))
        assert (boundary_pool_cuda.LAUNCHES - before[0],
                boundary_pool_cuda.BWD_LAUNCHES - before[1]) == (4, 4)
        assert_world_one_step(want, again, got, f'freeze_bn {freeze_bn}')
    finally:
        mesh.close()


@pytest.mark.cuda
def test_two_ranks_on_the_card_equal_one_process():
    need_card()
    cfg, model = setup()
    batch = tiny_train_batch(4, FRAMES, CROP, seed=4)
    ranks = Ranks(2, [('backends', dict(exact=True)),
                      ('train', dict(model=model,
                                     loss_cfg=factory.build_loss_config(cfg),
                                     weights=factory.build_loss_weights(cfg),
                                     batch=batch, epochs=[EPOCH],
                                     wd=1e-3))],
                  device='cuda')
    with tf32_off():
        state = state_on(cfg, model, 'cuda')
        want = step_record(state, step(cfg, state, batch))
    got = ranks.results()
    for r, res in enumerate(got):
        assert_same_step(want, res[1], f'rank {r}')
        assert res[1]['launches'] == (4, 4)
    assert np.isfinite(got[0][1]['metrics'][0]['cost'])
