"""The port's train step vs the JAX package's, on the CPU in float32.

From one set of flax variables (the flax model's init shapes, seeded
numpy values) carried over with `from_jax_variables`, both packages
take 3 Adam steps on the same numpy batches at epochs 9, 10 and 11, which
crosses the MIB gate (ibm_start 10) of the OpenTAL-final loss. Held: each
step's cost at rtol 1e-4 and each loss term at rtol 3e-4 (the k-step and
loss-term tolerances the JAX package met against the reference), the EDL
weight_accum at rtol 1e-5, the final parameters at rtol 1e-4 / atol 5e-5.
`test_torch_train_bn.py` takes one `freeze_bn: false` step the same way.
"""

import numpy as np
import pytest
import torch

from torch_suite import suite_policy  # noqa: F401 (autouse)

import jax
import jax.numpy as jnp

from opental_tpu.losses.edl import EDLConfig as JEDLConfig
from opental_tpu.losses.edl import EDLState as JEDLState
from opental_tpu.losses.multisegment import LossConfig as JLossConfig
from opental_tpu.models.bdnet import BDNet as JBDNet
from opental_tpu.train.step import (LossWeights as JLossWeights,
                                    TrainState as JTrainState,
                                    make_optimizer as jmake_optimizer,
                                    make_train_step)

from opental_torch.losses.edl import EDLConfig, EDLState
from opental_torch.losses.multisegment import LossConfig
from opental_torch.models.bdnet import BDNet
from opental_torch.train.step import (LossWeights, TrainState,
                                      make_optimizer, train_step)
from opental_torch.utils.convert import from_jax_variables

FRAME, CROP = 128, 32
LR, WD = 1e-5, 1e-3   # the shipped config's rates
EPOCHS = (9, 10, 11)
TERMS = ('loss_l', 'loss_c', 'loss_prop_l', 'loss_prop_c', 'loss_ct',
         'loss_act', 'loss_prop_act', 'loss_start', 'loss_end', 'loss_trip')


def make_batch(seed, batch_size=1):
    """A numpy batch with every input the step reads; clips channels-last
    as the dataset gives them."""
    rng = np.random.RandomState(seed)
    n_max = 4
    truths = np.zeros((batch_size, n_max, 2), np.float32)
    labels = np.zeros((batch_size, n_max), np.int32)
    gt_mask = np.zeros((batch_size, n_max), bool)
    for b in range(batch_size):
        k = rng.randint(1, n_max)
        s = rng.uniform(0, 0.7, k)
        truths[b, :k, 0] = s
        truths[b, :k, 1] = np.clip(s + rng.uniform(0.05, 0.3, k), 0, 1)
        labels[b, :k] = rng.randint(1, 16, k)
        gt_mask[b, :k] = True
    return {
        'clips': rng.uniform(-1, 1, (batch_size, FRAME, CROP, CROP, 3)
                             ).astype(np.float32),
        'truths': truths, 'labels': labels, 'gt_mask': gt_mask,
        'scores': (rng.rand(batch_size, 2, FRAME) > 0.9).astype(np.float32),
        'ssl_clips': rng.uniform(-1, 1, (batch_size, FRAME, CROP, CROP, 3)
                                 ).astype(np.float32),
        'ssl_props': np.tile(np.array([[[10., 40.], [60., 100.],
                                        [45., 55.]]], np.float32),
                             (batch_size, 1, 1)),
        'ssl_flags': np.array([1.0, 0.0][:batch_size], np.float32),
    }


EDL = dict(num_classes=15, loss_type='log', evidence='exp', iou_aware=True,
           with_ibm=True, ibm_start=10, momentum=0.99, num_bins=50)
LOSS = dict(num_classes=15, clip_length=FRAME, piou=0.5, cls_type='edl',
            os_head=True, act_margin=1.0, act_weight=0.0)


def numpy_variables(shapes, seed=0):
    """Values for the flax variable tree `shapes` (from `jax.eval_shape`
    of the model's init), made with numpy: glorot-uniform kernels as
    flax draws them, and every bias, scale and BN statistic moved off its
    init value (scale / var 1, bias / mean 0) so that every term of the
    math is exercised. Cheaper than compiling the init."""
    rng = np.random.RandomState(seed)

    def f(path, s):
        name = path[-1].key
        if name == 'kernel':
            rf = int(np.prod(s.shape[:-2]))
            lim = np.sqrt(6.0 / ((s.shape[-2] + s.shape[-1]) * rf))
            return rng.uniform(-lim, lim, s.shape).astype(np.float32)
        base = 1.0 if name in ('scale', 'var') else 0.0
        return (base + rng.uniform(0.05, 0.3, s.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(f, shapes)


def setup_pair(freeze_bn=True):
    jm = JBDNet(num_classes=16, os_head=True, use_edl=True, frame_num=FRAME,
                deterministic=False, freeze_bn=freeze_bn)
    x0 = jnp.zeros((1, FRAME, CROP, CROP, 3), jnp.float32)
    v = numpy_variables(dict(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                            x0)))
    jcfg = JLossConfig(edl=JEDLConfig(**EDL), **LOSS)
    tx = jmake_optimizer(LR, WD)
    jstate = JTrainState(params=v['params'], constants=v['constants'],
                         opt_state=tx.init(v['params']),
                         edl_state=JEDLState.create(jcfg.edl))
    jstep = jax.jit(make_train_step(jm, jcfg, JLossWeights(), tx))

    tm = BDNet(num_classes=16, os_head=True, use_edl=True, frame_num=FRAME,
               crop_size=CROP, freeze_bn=freeze_bn)
    tm.load_state_dict(from_jax_variables(v), strict=True)
    tstate = TrainState(model=tm, optimizer=make_optimizer(tm, LR, WD),
                        edl_state=EDLState.create(EDLConfig(**EDL)))
    tcfg = LossConfig(edl=EDLConfig(**EDL), **LOSS)
    return jstate, jstep, tstate, tcfg


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope='module')
def three_steps():
    jstate, jstep, tstate, tcfg = setup_pair()
    rows = []
    for i, epoch in enumerate(EPOCHS):
        batch = make_batch(seed=10 + i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()},
                           jnp.asarray(epoch))
        tm = train_step(tstate, tcfg, LossWeights(), _torch_batch(batch),
                        epoch)
        rows.append(({k: float(v) for k, v in jm.items()},
                     {k: float(v) for k, v in tm.items()},
                     np.asarray(jstate.edl_state.weight_accum),
                     tstate.edl_state.weight_accum.numpy().copy()))
    return jstate, tstate, rows


@pytest.mark.parametrize('i', range(len(EPOCHS)))
def test_step_costs_and_terms(three_steps, i):
    _, _, rows = three_steps
    jm, tm, _, _ = rows[i]
    np.testing.assert_allclose(tm['cost'], jm['cost'], rtol=1e-4,
                               err_msg=f'step {i} cost')
    for term in TERMS:
        np.testing.assert_allclose(tm[term], jm[term], rtol=3e-4,
                                   atol=1e-7, err_msg=f'step {i} {term}')
    assert tm['loss_trip'] > 0 and tm['loss_c'] > 0
    np.testing.assert_allclose(tm['grad_norm'], jm['grad_norm'], rtol=1e-3,
                               err_msg=f'step {i} grad_norm')


@pytest.mark.parametrize('i', range(len(EPOCHS)))
def test_edl_state(three_steps, i):
    _, _, rows = three_steps
    _, _, jw, tw = rows[i]
    np.testing.assert_allclose(tw, jw, rtol=1e-5)
    # the MIB state moves only from ibm_start on
    assert np.array_equal(tw, np.ones_like(tw)) == (EPOCHS[i] < 10)


def test_final_parameters(three_steps):
    jstate, tstate, _ = three_steps
    want = from_jax_variables({'params': jax.tree_util.tree_map(
        np.asarray, jstate.params)})
    got = dict(tstate.model.named_parameters())
    assert set(want) == set(got)
    moved = 0
    for key, w in want.items():
        g = got[key].detach()
        torch.testing.assert_close(g, w, rtol=1e-4, atol=5e-5,
                                   msg=lambda m: f'{key}: {m}')
        moved += int(not torch.equal(g, w))
    assert tstate.step == 3
    assert moved > 0
