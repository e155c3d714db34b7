"""`model.remat` in the port (each backbone block under
`torch.utils.checkpoint`) on the CPU in float32: the same state_dict
keys, outputs and gradients as the model without it (rtol 1e-5 for the
outputs, 1e-4 for the gradients, atol 1e-5, as `tests/test_remat.py`
holds JAX's remat against JAX's model), and after one `freeze_bn: false`
train step the same BN running statistics as the step without it (the
recompute in the backward does not update them a second time).

Against the JAX package's remat model the outputs hold at rtol 1e-5,
the global gradient norm at rtol 1e-5, and each gradient tensor within
2e-2 of its own norm: single elements of the deep layers' gradients
move with the order of float reductions (the stem weight's, summed over
every output position, differs from JAX's by up to 5.5e-3 of its
largest element and 4.9e-3 of its norm with 2 CPU threads, 2.3e-3 and
2.0e-3 with 8; remat off as on), while the norm agrees within 3e-7."""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from opental_tpu.models.bdnet import BDNet as JBDNet

from opental_torch import factory
from opental_torch.config import load_config
from opental_torch.models.bdnet import BDNet
from opental_torch.train.step import (LossWeights, TrainState,
                                      make_optimizer, train_step)
from opental_torch.utils.convert import from_jax_variables

from test_torch_train_step import (CROP, FRAME, _torch_batch, make_batch,
                                   numpy_variables, setup_pair)
from torch_suite import suite_policy  # noqa: F401 (autouse)


def _scalar(out):
    return (out['conf'].sum() + (out['loc'] * 1e-3).sum()
            + out['prop_conf'].sum())


@pytest.fixture(scope='module')
def pair():
    jm = JBDNet(num_classes=16, os_head=True, use_edl=True, frame_num=FRAME,
                remat=True)
    x0 = jnp.zeros((1, FRAME, CROP, CROP, 3), jnp.float32)
    v = numpy_variables(dict(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                            x0)), seed=3)
    x = np.random.RandomState(0).uniform(
        -1, 1, (1, FRAME, CROP, CROP, 3)).astype(np.float32)
    models = {}
    for remat in (False, True):
        tm = BDNet(num_classes=16, os_head=True, use_edl=True,
                   frame_num=FRAME, crop_size=CROP, remat=remat)
        tm.load_state_dict(from_jax_variables(v), strict=True)
        tm.train()
        xt = torch.from_numpy(np.ascontiguousarray(
            x.transpose(0, 4, 1, 2, 3)))
        out = tm(xt)
        _scalar(out).backward()
        grads = {k: p.grad.clone() for k, p in tm.named_parameters()
                 if p.grad is not None}
        models[remat] = (tm, out, grads)

    def f(params):
        out = jm.apply({'params': params, 'constants': v['constants']},
                       jnp.asarray(x))
        return _scalar(out), out
    (_, jout), jgrads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        v['params'])
    return models, jout, from_jax_variables(
        {'params': jax.tree_util.tree_map(np.asarray, jgrads)})


def test_same_state_dict_keys():
    cfg = load_config('configs/thumos14_opental_final.yaml')
    base = factory.build_model(cfg, frame_num=FRAME, crop_size=CROP)
    rmt = factory.build_model(load_config(
        'configs/thumos14_opental_final.yaml',
        overrides={'model.remat': True}), frame_num=FRAME, crop_size=CROP)
    assert rmt.backbone._model.remat and not base.backbone._model.remat
    assert list(rmt.state_dict()) == list(base.state_dict())


@pytest.mark.parametrize('ref', ['port', 'jax'])
def test_outputs_and_gradients(pair, ref):
    models, jout, jgrads = pair
    _, out, grads = models[True]
    if ref == 'port':
        _, want_out, want_grads = models[False]
        want_conf = want_out['conf'].detach().numpy()
    else:
        want_out, want_grads = jout, jgrads
        want_conf = np.asarray(jout['conf'])
    np.testing.assert_allclose(out['conf'].detach().numpy(), want_conf,
                               rtol=1e-5, atol=1e-5)
    # a parameter off the scalar's graph has no port gradient and a zero
    # JAX one
    assert set(grads) <= set(want_grads) and len(grads) > 100
    norms = []
    for k, w in want_grads.items():
        g = grads[k].numpy() if k in grads else np.zeros_like(w)
        w = np.asarray(w)
        if ref == 'port':
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5,
                                       err_msg=k)
        else:
            assert np.linalg.norm(g - w) <= 2e-2 * np.linalg.norm(w), k
        norms.append((np.square(g).sum(), np.square(w).sum()))
    g_norm, w_norm = np.sqrt(np.sum(norms, axis=0))
    np.testing.assert_allclose(g_norm, w_norm, rtol=1e-5)


def test_train_bn_step_updates_running_stats_once():
    """freeze_bn: false: the checkpointed blocks' BN normalizes by batch
    statistics in the first pass and again in the recompute; the running
    statistics move once per pass, as without remat."""
    _, _, base, tcfg = setup_pair(freeze_bn=False)
    model = BDNet(num_classes=16, os_head=True, use_edl=True,
                  frame_num=FRAME, crop_size=CROP, freeze_bn=False,
                  remat=True)
    model.load_state_dict(base.model.state_dict(), strict=True)
    rmt = TrainState(model=model, optimizer=make_optimizer(model, 1e-5, 1e-3),
                     edl_state=copy.deepcopy(base.edl_state))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    batch = make_batch(seed=21)
    want = train_step(base, tcfg, LossWeights(), _torch_batch(batch), 10)
    got = train_step(rmt, tcfg, LossWeights(), _torch_batch(batch), 10)
    np.testing.assert_allclose(float(got['cost']), float(want['cost']),
                               rtol=1e-5)
    sd, n = base.model.state_dict(), 0
    for k, v in model.state_dict().items():
        if k.endswith(('running_mean', 'running_var')):
            assert not torch.equal(v, before[k]), k
            torch.testing.assert_close(v, sd[k], rtol=1e-5, atol=1e-6,
                                       msg=lambda m: f'{k}: {m}')
            n += 1
    assert n > 100


def test_no_checkpoint_without_grad(monkeypatch):
    """Inference (no gradient) runs the blocks as they are."""
    from opental_torch.models import i3d
    monkeypatch.setattr(i3d, 'checkpoint', None)
    model = BDNet(num_classes=16, os_head=True, use_edl=True,
                  frame_num=FRAME, crop_size=CROP, remat=True).eval()
    with torch.no_grad():
        out = model(torch.zeros(1, 3, FRAME, CROP, CROP))
    assert out['conf'].shape[0] == 1
