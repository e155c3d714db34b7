"""Port BDNet (OpenTAL-final flags: os_head + EDL, exp evidence) vs the
JAX BDNet on the CPU in float32, on JAX init variables (spread) carried
over by from_jax_variables. Tolerances are the JAX package's own against
the reference: I3D endpoints atol 2e-4 (tests/test_i3d_parity.py), the
out_dict rtol 1e-3 / atol 2e-3 (tests/test_bdnet_parity.py)."""

import numpy as np
import pytest
import torch

from torch_suite import suite_policy  # noqa: F401 (autouse)

import jax
import jax.numpy as jnp

from opental_tpu.models import bdnet as jb

from opental_torch.models import bdnet as tb
from opental_torch.utils.convert import from_jax_variables, map_jax_path

FRAMES, CROP = 128, 32
OUT_KEYS = ('loc', 'conf', 'prop_loc', 'prop_conf', 'center', 'act',
            'prop_act', 'start', 'end', 'start_loc_prop', 'end_loc_prop',
            'start_conf_prop', 'end_conf_prop', 'unct', 'prop_unct',
            'priors')


def _spread(variables, seed=0):
    rng = np.random.RandomState(seed)

    def f(path, a):
        a = np.asarray(a)
        if path[-1].key == 'kernel':
            return a
        return a + rng.uniform(0.05, 0.3, a.shape).astype(a.dtype)
    return jax.tree_util.tree_map_with_path(f, variables)


@pytest.fixture(scope='module')
def models():
    x = np.random.RandomState(0).randn(2, FRAMES, CROP, CROP, 3).astype(
        np.float32) * 0.5
    jm = jb.BDNet(num_classes=16, os_head=True, use_edl=True,
                  frame_num=FRAMES)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x[:1]))
    v = _spread(jax.tree_util.tree_map(np.asarray, v))
    tm = tb.BDNet(num_classes=16, os_head=True, use_edl=True,
                  frame_num=FRAMES, crop_size=CROP).eval()
    tm.load_state_dict(from_jax_variables(v), strict=True)
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 4, 1, 2, 3)))
    return jm, v, tm, x, xt


def test_i3d_endpoints(models):
    jm, v, tm, x, xt = models
    want = jax.jit(lambda vv, xx: jm.apply(
        vv, xx, method=jb.BDNet.backbone_features))(v, jnp.asarray(x))
    with torch.no_grad():
        got = tm.backbone(xt)
    for ep in ('Mixed_4f', 'Mixed_5c'):
        g = np.moveaxis(got[ep].numpy(), 1, -1)
        w = np.asarray(want[ep])
        assert g.shape == w.shape, (ep, g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-4, err_msg=ep)


def test_out_dict(models):
    jm, v, tm, x, xt = models
    want = jax.jit(jm.apply)(v, jnp.asarray(x))
    with torch.no_grad():
        got = tm(xt)
    assert set(k for k in want if want[k] is not None) >= set(OUT_KEYS)
    for key in OUT_KEYS:
        g, w = got[key].numpy(), np.asarray(want[key])
        assert g.shape == w.shape, (key, g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=2e-3, err_msg=key)


def test_missing_key_raises(models):
    _, v, _, _, _ = models
    params = jax.tree_util.tree_map(lambda a: a, v['params'])
    del params['pyramid']['center_head']
    tm = tb.BDNet(num_classes=16, os_head=True, use_edl=True,
                  frame_num=FRAMES, crop_size=CROP)
    with pytest.raises(RuntimeError, match='center_head'):
        tm.load_state_dict(from_jax_variables(
            {'params': params, 'constants': v['constants']}), strict=True)


def test_extra_key_raises(models):
    """A JAX leaf with no port counterpart raises (an invented
    `transformer_head`; the transformer conf head lives under
    `conf_head`); the RPL radius, ported with the RPL heads, maps to the
    pyramid's `rpl_radius`."""
    _, v, _, _, _ = models
    params = dict(v['params'])
    params['pyramid'] = dict(params['pyramid'], transformer_head={
        'kernel': np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError, match='transformer_head'):
        from_jax_variables({'params': params,
                            'constants': v['constants']})
    with pytest.raises(KeyError):
        map_jax_path(('pyramid', 'transformer_head', 'kernel'))
    assert map_jax_path(('pyramid', 'rpl_radius')) == (
        'coarse_pyramid_detection.rpl_radius', None)


@pytest.mark.parametrize('evidence', ['relu', 'exp', 'softplus'])
def test_dirichlet_heads(evidence):
    logit = np.random.RandomState(1).randn(3, 7, 15).astype(np.float32) * 6
    for jf, tf in ((jb.dirichlet_uncertainty, tb.dirichlet_uncertainty),
                   (jb.dirichlet_expected_prob, tb.dirichlet_expected_prob)):
        np.testing.assert_allclose(
            tf(torch.from_numpy(logit), evidence).numpy(),
            np.asarray(jf(jnp.asarray(logit), evidence)), rtol=1e-6,
            atol=1e-7)
