"""An ActivityNet train step on the data mesh vs the JAX package's.

Two gloo ranks on the CPU take one dual-LR step of the ANet BDNet (frame
256, crop 32) past the exp-form MIB gate on a global uint8 batch of 4
from the synthetic ANet dataset (padded clips with their pad masks, two
rows a rank); the JAX package takes it on `make_mesh(2)`. The ANet loss
threads the EDL state sample by sample in batch order, so the ranks must
take it over the gathered global batch. Held: metrics rtol 2e-4 / atol
1e-6, gradients by `assert_same_grads`, parameters rtol 1e-4 / atol
5e-5, the EDL state rtol 2e-4, both ranks equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from opental_tpu.losses.edl import EDLConfig as JEDLConfig
from opental_tpu.losses.edl import EDLState as JEDLState
from opental_tpu.losses.multisegment import LossConfig as JLossConfig
from opental_tpu.models.bdnet import BDNet as JBDNet
from opental_tpu.parallel import mesh as jmesh
from opental_tpu.train.step import (LossWeights as JLossWeights,
                                    TrainState as JTrainState,
                                    make_anet_optimizer as jmake_optimizer,
                                    make_train_step)

from opental_torch.config import load_config
from opental_torch.data.anet import AnetTrainDataset
from opental_torch.losses.edl import EDLConfig
from opental_torch.losses.multisegment import LossConfig
from opental_torch.models.bdnet import BDNet
from opental_torch.parallel.dryrun import (LR, Ranks, assert_same_grads,
                                           grad_gaps)
from opental_torch.train.step import LossWeights
from opental_torch.utils.convert import from_jax_variables
from opental_torch.utils.synthetic import make_synthetic_anet_dataset

from test_torch_anet_model import numpy_variables
from test_torch_anet_train import CLASSES, CROP, EDL, FRAME, LOSS, TERMS, \
    WD
from test_torch_mesh_train import keeping_grads, port_grads
from torch_suite import suite_policy  # noqa: F401 (autouse)

WORLD, BATCH, EPOCH = 2, 4, 11


@pytest.fixture(scope='module')
def anet_steps(tmp_path_factory):
    root = tmp_path_factory.mktemp('mesh_anet')
    cfg = load_config(make_synthetic_anet_dataset(
        str(root / 'synth'), n_train=6, n_val=1, clip_length=FRAME,
        crop_size=CROP))
    ds = AnetTrainDataset(cfg.get_path('dataset.training.video_info_path'),
                          cfg.get_path('dataset.training.video_data_path'),
                          clip_length=FRAME, crop_size=CROP, seed=1,
                          uint8_ingest=True)
    batch = next(iter(ds.batches(BATCH)))
    assert batch['pad_masks'].any()

    jm = JBDNet(num_classes=CLASSES, os_head=True, use_edl=True,
                frame_num=FRAME, arch='anet', deterministic=False)
    v = numpy_variables(dict(jax.eval_shape(
        jm.init, jax.random.PRNGKey(0),
        jnp.zeros((1, FRAME, CROP, CROP, 3), jnp.float32))))
    tm = BDNet(num_classes=CLASSES, os_head=True, use_edl=True,
               frame_num=FRAME, crop_size=CROP, arch='anet')
    tm.load_state_dict(from_jax_variables(v), strict=True)
    ranks = Ranks(WORLD, [('train', dict(
        model=tm, loss_cfg=LossConfig(edl=EDLConfig(**EDL), **LOSS),
        weights=LossWeights(), batch=batch, epochs=[EPOCH], wd=WD))],
        root=str(root))

    jcfg = JLossConfig(edl=JEDLConfig(**EDL), **LOSS)
    tx = keeping_grads(jmake_optimizer(LR, WD))
    state = JTrainState(params=v['params'], constants=v['constants'],
                        opt_state=tx.init(v['params']),
                        edl_state=JEDLState.create(jcfg.edl))
    mesh = jmesh.make_mesh(WORLD)
    step = jax.jit(make_train_step(jm, jcfg, JLossWeights(), tx))
    state, metrics = step(jmesh.replicate(mesh, state),
                          jmesh.shard_batch(mesh, {
                              k: jnp.asarray(x) for k, x in batch.items()}),
                          jnp.asarray(EPOCH))
    want = {
        'metrics': {k: float(x) for k, x in metrics.items()},
        'params': from_jax_variables({'params': jax.tree_util.tree_map(
            np.asarray, state.params), 'constants': state.constants}),
        'edl': {k: np.asarray(x) for k, x in
                state.edl_state._asdict().items()},
        'grads': port_grads(state.opt_state[0])}
    return want, [r[0] for r in ranks.results()]


def test_anet_metrics_match_jax_mesh(anet_steps):
    want, got = anet_steps
    for rank, res in enumerate(got):
        for k in TERMS + ('cost', 'grad_norm'):
            np.testing.assert_allclose(res['metrics'][0][k],
                                       want['metrics'][k], rtol=2e-4,
                                       atol=1e-6, err_msg=f'rank {rank} {k}')


def test_anet_gradients_match_jax_mesh(anet_steps, record_property):
    want, got = anet_steps
    record_property('grad_gaps', grad_gaps(want['grads'], got[0]['grads']))
    for rank, res in enumerate(got):
        assert_same_grads(want['grads'], res['grads'], f'rank {rank}')


def test_anet_parameters_match_jax_mesh(anet_steps):
    want, got = anet_steps
    for rank, res in enumerate(got):
        for k, p in res['params'].items():
            torch.testing.assert_close(p, want['params'][k], rtol=1e-4,
                                       atol=5e-5,
                                       msg=lambda m: f'rank {rank} {k}: {m}')


def test_anet_edl_state_and_ranks_equal(anet_steps):
    want, got = anet_steps
    for k, x in want['edl'].items():
        np.testing.assert_allclose(got[0]['edl'][k].numpy(), x, rtol=2e-4,
                                   atol=1e-7, err_msg=k)
        assert torch.equal(got[0]['edl'][k], got[1]['edl'][k]), k
    assert got[0]['metrics'] == got[1]['metrics']
    for k, p in got[0]['params'].items():
        assert torch.equal(p, got[1]['params'][k]), k
