"""The port's ActivityNet training loop on the CPU: `init_state`'s
dual-LR optimizer and head re-initialization, and `train` end to end (2
steps on the synthetic ANet dataset with uint8 ingest, a checkpoint
saved and restored). Apart from `test_torch_anet_train.py` (the step
against JAX) so that the two run on separate workers under `--dist
loadfile`.
"""

import os

import pytest
import torch

from opental_torch.config import load_config
from opental_torch.train import checkpoint
from opental_torch.train.loop import init_state, train
from opental_torch.utils.synthetic import make_synthetic_anet_dataset

from torch_suite import suite_policy  # noqa: F401 (autouse)

FRAME, CROP = 256, 32


@pytest.fixture(scope='module')
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('anet_train') / 'synth')
    return make_synthetic_anet_dataset(root, n_train=6, n_val=1,
                                       clip_length=FRAME, crop_size=CROP)


def test_backbone_takes_a_tenth_of_the_rate(dataset):
    """init_state builds the dual-LR optimizer for an ANet config and
    re-initializes its heads."""
    cfg = load_config(dataset)
    state = init_state(cfg, torch.device('cpu'), seed=0, frame_num=FRAME,
                       crop_size=CROP)
    heads, backbone = state.optimizer.param_groups
    assert heads['lr'] == pytest.approx(1e-4)
    assert backbone['lr'] == pytest.approx(1e-5)
    names = {id(p): n for n, p in state.model.named_parameters()}
    assert all(names[id(p)].startswith('backbone.')
               for p in backbone['params'])
    assert not any(names[id(p)].startswith('backbone.')
                   for p in heads['params'])
    assert len(heads['params']) + len(backbone['params']) == len(names)
    w = state.model.coarse_pyramid_detection.center_head.conv1d.weight
    assert abs(w.std().item() - 0.01) < 0.004


def test_train_loop_end_to_end(dataset):
    """tools.train's loop on the ANet config (uint8 ingest): 2 steps,
    a checkpoint saved and resumed with both optimizer groups."""
    cfg = load_config(dataset, overrides={'training.uint8_ingest': True})
    state = train(cfg, max_steps_per_epoch=2, device='cpu')
    assert state.step == 2
    ckdir = cfg.training.checkpoint_path
    checkpoint.save(ckdir, 1, state)
    again = init_state(cfg, torch.device('cpu'), seed=1, frame_num=FRAME,
                       crop_size=CROP)
    assert checkpoint.restore(ckdir, None, again) == 1
    assert again.step == 2
    assert [g['lr'] for g in again.optimizer.param_groups] == \
        pytest.approx([1e-4, 1e-5])
    for k, v in state.model.state_dict().items():
        torch.testing.assert_close(again.model.state_dict()[k], v)
    with open(os.path.join(ckdir, 'metrics.jsonl')) as f:
        assert len(f.readlines()) == 2
