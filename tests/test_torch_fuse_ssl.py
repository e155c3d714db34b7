"""The fused SSL step (`fuse_ssl`, `BDNet.train_forward`) on the CPU in
float32: the port's fused step against its sequential step (metrics at
rtol 2e-4 / atol 1e-6, parameters at rtol 1e-4 / atol 5e-5, the JAX
package's own tolerances, `tests/test_train_step.py:142-178`) and
against the JAX package's fused `make_train_step` (loss terms at rtol
3e-4, the cost at rtol 1e-4), from one set of flax variables; each
parameter's gradient, fused against sequential, by its norm (the
post-Adam parameters at LR 1e-5 cannot show a gradient fault); with
`freeze_bn: false` the switch takes the sequential path."""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from opental_tpu.losses.edl import EDLConfig as JEDLConfig
from opental_tpu.losses.multisegment import LossConfig as JLossConfig
from opental_tpu.models.bdnet import BDNet as JBDNet
from opental_tpu.train.step import (LossWeights as JLossWeights,
                                    make_optimizer as jmake_optimizer,
                                    make_train_step)

from opental_torch.models import bdnet as bdnet_mod
from opental_torch.models import pyramid
from opental_torch.train.step import (LossWeights, TrainState,
                                      make_optimizer, train_step)

from test_torch_train_step import (EDL, FRAME, LOSS, LR, TERMS, WD,
                                   _torch_batch, make_batch, setup_pair)
from torch_suite import suite_policy  # noqa: F401 (autouse)

EPOCH = 11


def _fork(tstate):
    """An independent copy of a port train state before its first step."""
    model = copy.deepcopy(tstate.model)
    return TrainState(model=model, optimizer=make_optimizer(model, LR, WD),
                      edl_state=copy.deepcopy(tstate.edl_state))


def _count_calls(monkeypatch, calls):
    """Count the pool calls and the model's passes of a step."""
    def wrap(mod, name, key):
        fn = getattr(mod, name)

        def counted(*a, **k):
            calls[key] = calls.get(key, 0) + 1
            return fn(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    wrap(pyramid, 'boundary_max_pool_segmented', 'pool')
    wrap(bdnet_mod, 'boundary_max_pool_segmented', 'pool')
    wrap(bdnet_mod.BDNet, 'train_forward', 'train_forward')
    wrap(bdnet_mod.BDNet, 'ssl_forward', 'ssl_forward')


@pytest.fixture(scope='module')
def steps():
    jstate, _, tstate, tcfg = setup_pair()
    seq = _fork(tstate)
    batch = make_batch(seed=30)
    mp = pytest.MonkeyPatch()
    calls = {'fused': {}, 'seq': {}}
    try:
        _count_calls(mp, calls['fused'])
        fused_m = train_step(tstate, tcfg, LossWeights(), _torch_batch(batch),
                             EPOCH, fuse_ssl=True)
        mp.undo()
        _count_calls(mp, calls['seq'])
        seq_m = train_step(seq, tcfg, LossWeights(), _torch_batch(batch),
                           EPOCH)
    finally:
        mp.undo()
    jm = JBDNet(num_classes=16, os_head=True, use_edl=True, frame_num=FRAME,
                deterministic=False)
    jstep = jax.jit(make_train_step(
        jm, JLossConfig(edl=JEDLConfig(**EDL), **LOSS), JLossWeights(),
        jmake_optimizer(LR, WD), fuse_ssl=True))
    _, jax_m = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                     jnp.asarray(EPOCH))
    return tstate, seq, fused_m, seq_m, jax_m, calls


def test_fused_equals_sequential(steps):
    fused, seq, fused_m, seq_m, _, _ = steps
    assert set(fused_m) == set(seq_m)
    for k in seq_m:
        np.testing.assert_allclose(float(fused_m[k]), float(seq_m[k]),
                                   rtol=2e-4, atol=1e-6, err_msg=k)
    assert float(fused_m['loss_trip']) > 0
    want = dict(seq.model.named_parameters())
    for key, p in fused.model.named_parameters():
        torch.testing.assert_close(p.detach(), want[key].detach(),
                                   rtol=1e-4, atol=5e-5,
                                   msg=lambda m: f'{key}: {m}')


def test_fused_gradients_equal_sequential(steps):
    """Each parameter's gradient of the two steps, fused against
    sequential: |g_fused - g_seq| <= 4e-2 |g_seq| (Frobenius norms).
    Rounding alone moves the stem weight's gradient by up to 1.96e-2 of
    its norm here (the sequential step at 1 against 2 threads; 1.81e-2
    fused against sequential); the SSL features detached in the fused
    pass move it by 9.24e-2."""
    fused, seq, *_ = steps
    want = {n: p.grad for n, p in seq.model.named_parameters()}
    got = dict(fused.model.named_parameters())
    assert len(want) > 100
    for key, g in want.items():
        gap = (got[key].grad - g).norm().item()
        assert gap <= 4e-2 * g.norm().item(), (key, gap, g.norm().item())


def test_fused_equals_jax_fused_step(steps):
    _, _, fused_m, _, jax_m, _ = steps
    for term in TERMS:
        np.testing.assert_allclose(float(fused_m[term]), float(jax_m[term]),
                                   rtol=3e-4, atol=1e-7, err_msg=term)
    np.testing.assert_allclose(float(fused_m['cost']), float(jax_m['cost']),
                               rtol=1e-4)


def test_one_pass_and_the_same_pools(steps):
    """The fused step runs one 2B pass and no SSL pass; both steps pool
    four times (the 2 pools of a pass, the 2 of the SSL triplets)."""
    *_, calls = steps
    assert calls['fused'] == {'train_forward': 1, 'pool': 4}
    assert calls['seq'] == {'ssl_forward': 1, 'pool': 4}


def test_train_bn_takes_the_sequential_path(monkeypatch):
    """freeze_bn: false: each pass draws its own batch statistics, so
    fuse_ssl changes nothing: no 2B pass, the same step."""
    _, _, tstate, tcfg = setup_pair(freeze_bn=False)
    seq = _fork(tstate)
    batch = make_batch(seed=31)
    calls = {}
    _count_calls(monkeypatch, calls)
    got = train_step(tstate, tcfg, LossWeights(), _torch_batch(batch),
                     EPOCH, fuse_ssl=True)
    assert calls.get('train_forward', 0) == 0 and calls['ssl_forward'] == 1
    want = train_step(seq, tcfg, LossWeights(), _torch_batch(batch), EPOCH)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    sd = seq.model.state_dict()
    for k, v in tstate.model.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_ssl_weight_zero_takes_no_ssl_pass(monkeypatch):
    _, _, tstate, tcfg = setup_pair()
    calls = {}
    _count_calls(monkeypatch, calls)
    m = train_step(tstate, tcfg, LossWeights(ssl=0.0),
                   _torch_batch(make_batch(seed=32)), EPOCH, fuse_ssl=True)
    assert 'train_forward' not in calls and 'ssl_forward' not in calls
    assert float(m['loss_trip']) == 0.0
