"""`freeze_bn: false` on the data mesh: global-batch BN statistics.

Two gloo ranks on the CPU take one step of the train-mode-BN
OpenTAL-final model on a global batch of 4 (`test_torch_mesh_train.py`'s
setup); the JAX package takes it on `make_mesh(2)`, where XLA reduces
the batch-axis statistics across shards. Held: metrics rtol 2e-4 / atol
1e-6, gradients by `assert_same_grads`, parameters (gamma / beta among
them) rtol 1e-4 / atol 5e-5, every
BN running statistic equal on both ranks and to JAX's at rtol 1e-4 /
atol 1e-5 (`test_torch_train_bn.py`'s tolerance). A mesh of one gives
the local statistics: its step equals the plain step bit for bit.
"""

import numpy as np
import pytest
import torch

from opental_torch.losses.edl import EDLState
from opental_torch.parallel.dryrun import (Ranks, assert_same_grads,
                                           grad_gaps)
from opental_torch.train.step import (LossWeights, TrainState,
                                      make_optimizer, train_step)

from test_torch_mesh_train import (EPOCH, LR, TERMS, WD, WORLD,
                                   jax_mesh_step, jax_variables, mesh_batch,
                                   port_loss, port_model, train_job)
from torch_suite import suite_policy  # noqa: F401 (autouse)

STATS = ('running_mean', 'running_var')


@pytest.fixture(scope='module')
def bn_steps(tmp_path_factory):
    """JAX's mesh step; the two ranks' results; a mesh of one's result
    beside the plain step (one thread each)."""
    jm, v = jax_variables(freeze_bn=False)
    batch = mesh_batch(seed=40)
    small = mesh_batch(seed=41, batch_size=2)
    root = str(tmp_path_factory.mktemp('mesh_bn'))
    ranks = Ranks(WORLD, [train_job(port_model(v, False), batch)],
                  root=root)
    one = Ranks(1, [train_job(port_model(v, False), small)], root=root)
    want = jax_mesh_step(jm, v, batch)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        model = port_model(v, False)
        state = TrainState(model=model,
                           optimizer=make_optimizer(model, LR, WD),
                           edl_state=EDLState.create(port_loss().edl))
        plain = train_step(state, port_loss(), LossWeights(),
                           {k: torch.from_numpy(x)
                            for k, x in small.items()}, EPOCH)
    finally:
        torch.set_num_threads(threads)
    return (want, [r[0] for r in ranks.results()], one.results()[0][0],
            ({k: float(x) for k, x in plain.items()}, model))


def test_bn_metrics_match_jax_mesh(bn_steps):
    (jm, _, _, _), got, _, _ = bn_steps
    for rank, res in enumerate(got):
        for k in TERMS + ('cost', 'grad_norm'):
            np.testing.assert_allclose(res['metrics'][0][k], jm[k],
                                       rtol=2e-4, atol=1e-6,
                                       err_msg=f'rank {rank} {k}')


def test_bn_gradients_match_jax_mesh(bn_steps, record_property):
    """The gradients through the global batch statistics (the backward
    of BN's all-reduces) against JAX's (junit property `grad_gaps`)."""
    (_, _, _, grads), got, _, _ = bn_steps
    assert 'backbone._model.Conv3d_1a_7x7.bn.weight' in grads
    record_property('grad_gaps', grad_gaps(grads, got[0]['grads']))
    for rank, res in enumerate(got):
        assert_same_grads(grads, res['grads'], f'rank {rank}')


def test_bn_parameters_match_jax_mesh(bn_steps):
    (_, sd, _, _), got, _, _ = bn_steps
    gamma = 'backbone._model.Conv3d_1a_7x7.bn.weight'
    for rank, res in enumerate(got):
        assert gamma in res['params']
        for k, p in res['params'].items():
            torch.testing.assert_close(p, sd[k], rtol=1e-4, atol=5e-5,
                                       msg=lambda m: f'rank {rank} {k}: {m}')


def test_running_statistics_global_and_equal(bn_steps):
    (_, sd, _, _), got, _, _ = bn_steps
    n_stats = 0
    for k, x in got[0]['buffers'].items():
        if not k.endswith(STATS):
            continue
        assert torch.equal(x, got[1]['buffers'][k]), k
        torch.testing.assert_close(x, sd[k], rtol=1e-4, atol=1e-5,
                                   msg=lambda m: f'{k}: {m}')
        n_stats += 1
    assert n_stats > 100
    moved = 'backbone._model.Conv3d_1a_7x7.bn.running_mean'
    assert not torch.equal(got[0]['buffers'][moved],
                           port_model(jax_variables(False)[1],
                                      False).state_dict()[moved])


def test_mesh_of_one_bn_equals_local(bn_steps):
    _, _, one, (plain, model) = bn_steps
    assert one['metrics'][0] == plain
    for k, p in model.named_parameters():
        assert torch.equal(one['params'][k], p.detach()), k
    for k, x in model.named_buffers():
        assert torch.equal(one['buffers'][k], x), k
