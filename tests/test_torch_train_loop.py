"""The port's training entry points end to end on the CPU, on a synthetic
dataset: `train` for 2 epochs of 1 step, a checkpoint, `tools.train`
resuming from it for one more epoch (which saves its own checkpoint and
the latest link), and the saved weights through `run_test` to a
detection JSON (the I3D backbone file overlaid at init:
`test_torch_train_loop_backbone.py`)."""

import json
import os

import pytest
import torch

from torch_suite import suite_policy  # noqa: F401 (autouse)

from opental_torch.config import load_config
from opental_torch.tools import train as train_cli
from opental_torch.tools.test import run_test
from opental_torch.train import checkpoint as ckpt
from opental_torch.train.loop import SAVE_AFTER_EPOCH, train
from opental_torch.utils.synthetic import make_synthetic_dataset


@pytest.fixture(scope='module')
def trained(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('loop') / 'synth')
    cfg_path = make_synthetic_dataset(root, n_train=3, n_test=1,
                                      clip_length=128, crop_size=32,
                                      spatial=40)
    cfg = load_config(cfg_path, overrides={'training.max_epoch': 2})
    state = train(cfg, max_steps_per_epoch=1, device='cpu')
    ckdir = cfg.training.checkpoint_path
    # the loop itself saves from epoch 11 on: label this state epoch 10
    ckpt.save(ckdir, SAVE_AFTER_EPOCH, state)
    first = {k: v.clone() for k, v in state.model.state_dict().items()}
    train_cli.main([cfg_path, '--device', 'cpu', '--max_steps_per_epoch',
                    '1', '--resume', '-1',
                    '--max_epoch', str(SAVE_AFTER_EPOCH + 1)])
    return cfg_path, cfg, state, first


def test_first_run(trained):
    _, cfg, state, _ = trained
    assert state.step == 2
    with open(os.path.join(cfg.training.checkpoint_path,
                           'metrics.jsonl')) as f:
        recs = [json.loads(line) for line in f]
    assert [r['step'] for r in recs[:2]] == [1, 2]
    for r in recs:
        assert {'cost', 'loss_c', 'loss_trip', 'grad_norm'} <= set(r)
        assert all(v == v for v in r.values())          # no NaN


def test_resume_steps_once_and_saves(trained):
    _, cfg, _, first = trained
    ckdir = cfg.training.checkpoint_path
    assert ckpt.latest_epoch(ckdir) == SAVE_AFTER_EPOCH + 1
    payload = torch.load(ckpt.epoch_path(ckdir, SAVE_AFTER_EPOCH + 1),
                         weights_only=True)
    assert payload['step'] == 3
    assert payload['epoch'] == SAVE_AFTER_EPOCH + 1
    moved = [k for k, v in payload['model'].items()
             if v.is_floating_point() and not torch.equal(v, first[k])]
    assert any('conv' in k for k in moved)
    # epoch 11 is past ibm_start 10: the MIB state has moved
    assert not torch.equal(payload['edl_state']['weight_accum'],
                           torch.ones(50))
    with open(os.path.join(ckdir, 'metrics.jsonl')) as f:
        assert [json.loads(line)['step'] for line in f] == [1, 2, 3]


def test_saved_weights_run_test(trained):
    cfg_path, cfg, _, _ = trained
    test_cfg = load_config(cfg_path, overrides={
        'model.compute_dtype': 'float32'})
    path = run_test(test_cfg, device='cpu')
    with open(path) as f:
        payload = json.load(f)
    assert len(payload['results']) == 1
    props = next(iter(payload['results'].values()))
    assert props and {'label', 'score', 'segment'} <= set(props[0])
