"""The RPL and GCPL baselines on the data mesh: both configs return the
RPL radius and centers among the model's outputs; RPL's radius is read
only by its loss and GCPL's by nothing. A mesh of one (gloo) takes three
steps (DDP's static graph learns the parameter set in the first and
holds the later steps to it) equal to three plain steps bit for bit.
"""

import copy
import os

import pytest
import torch

from opental_torch import factory
from opental_torch.config import load_config
from opental_torch.parallel import mesh as meshlib
from opental_torch.train.step import (TrainState, make_data_parallel,
                                      make_optimizer, train_step)

from test_torch_mesh_train import CROP, EPOCH, FRAME, LR, WD, mesh_batch
from torch_suite import suite_policy  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

@pytest.mark.parametrize('baseline', ['gcpl', 'rpl'])
def test_rpl_steps_on_a_mesh_of_one(baseline):
    """Three DDP steps at world size 1 == three plain steps, one
    thread each side."""
    cfg = load_config(os.path.join(ROOT, 'configs',
                                   f'thumos14_open_{baseline}.yaml'))
    model = factory.init_train_weights(factory.build_model(
        cfg, frame_num=FRAME, crop_size=CROP), seed=0)
    loss_cfg = factory.build_loss_config(cfg)._replace(clip_length=FRAME)
    batch = {k: torch.from_numpy(v) for k, v in mesh_batch(
        seed=32, batch_size=1).items()}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    mesh = meshlib.make_mesh(world_size=1, rank=0, device='cpu')
    try:
        runs = []
        for ddp in (False, True):
            m = copy.deepcopy(model)
            state = TrainState(model=m, optimizer=make_optimizer(m, LR, WD))
            if ddp:
                make_data_parallel(state, mesh)
            runs.append(([{k: float(v) for k, v in train_step(
                state, loss_cfg, factory.build_loss_weights(cfg), batch,
                EPOCH).items()} for _ in range(3)], m.state_dict()))
    finally:
        mesh.close()
        torch.set_num_threads(threads)
    (want, sd), (got, sd_ddp) = runs
    assert got == want
    for k, v in sd.items():
        assert torch.equal(sd_ddp[k], v), k
