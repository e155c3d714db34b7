"""Port layers vs the flax layers of the JAX package, on the CPU in
float32, with the flax variables carried over by from_jax_variables.
Tolerance rtol 1e-5 / atol 1e-5 (convolutions sum in another order)."""

import numpy as np
import pytest
import torch

from torch_suite import suite_policy  # noqa: F401 (autouse)

import jax
import jax.numpy as jnp

from opental_tpu.models import layers as jl
from opental_tpu.models import pyramid as jp
from opental_tpu.models.i3d import MAXPOOL_SPECS, Stem

from opental_torch.models import layers as tl
from opental_torch.models import pyramid as tp
from opental_torch.utils.convert import from_jax_variables

TOL = dict(rtol=1e-5, atol=1e-5)


def _nest(path, tree):
    for p in reversed(path):
        tree = {p: tree}
    return tree


def port_state(variables, path, strip):
    """Flax variables of one layer, placed at `path` of the BDNet tree,
    through from_jax_variables; keys with the `strip` prefix removed."""
    sd = from_jax_variables({col: _nest(path, jax.tree_util.tree_map(
        np.asarray, dict(tree))) for col, tree in variables.items()})
    assert all(k.startswith(strip) for k in sd), list(sd)
    return {k[len(strip):]: v for k, v in sd.items()}


def randomize(variables, seed):
    """Spread every leaf but the (glorot) kernels, so that zero biases
    and unit norms cannot hide a wrong mapping."""
    rng = np.random.RandomState(seed)

    def f(path, a):
        a = np.asarray(a)
        if path[-1].key == 'kernel':
            return jnp.asarray(a)
        return jnp.asarray(a + rng.uniform(0.1, 0.5, a.shape).astype(
            a.dtype))
    return jax.tree_util.tree_map_with_path(f, variables)


def to_ncthw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(x, -1, 1)))


def from_ncthw(y):
    return np.moveaxis(y.detach().numpy(), 1, -1)


UNIT3D_CASES = [  # (T, H, kernel, stride)
    (8, 9, (3, 3, 3), (1, 1, 1)),
    (7, 10, (3, 3, 3), (1, 1, 1)),
    (8, 10, (3, 3, 3), (2, 2, 2)),
    (9, 11, (3, 3, 3), (2, 2, 2)),
    (10, 12, (7, 7, 7), (2, 2, 2)),
    (9, 11, (7, 7, 7), (2, 2, 2)),
]


@pytest.mark.parametrize('t,h,kernel,stride', UNIT3D_CASES)
def test_unit3d_same(t, h, kernel, stride):
    rng = np.random.RandomState(t * 100 + h)
    x = rng.randn(2, t, h, h + 1, 3).astype(np.float32)
    jm = jl.Unit3D(8, kernel=kernel, stride=stride)
    v = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 1)
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    tm = tl.Unit3D(3, 8, kernel, stride)
    tm.load_state_dict(port_state(v, ('backbone', 'U'), 'backbone._model.U.'))
    got = from_ncthw(tm(to_ncthw(x)))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize('t,h', [(10, 12), (9, 11)])
def test_stem_equals_space_to_depth(t, h):
    """The port's plain stride-2 7^3 stem == the JAX space-to-depth stem
    on the same weights."""
    rng = np.random.RandomState(t)
    x = rng.randn(1, t, h, h, 3).astype(np.float32)
    jm = Stem(16)
    v = randomize(jm.init(jax.random.PRNGKey(1), jnp.asarray(x)), 2)
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    tm = tl.Unit3D(3, 16, (7, 7, 7), (2, 2, 2))
    tm.load_state_dict(port_state(v, ('backbone', 'Conv3d_1a_7x7'),
                                  'backbone._model.Conv3d_1a_7x7.'))
    np.testing.assert_allclose(from_ncthw(tm(to_ncthw(x))), want, **TOL)


@pytest.mark.parametrize('name', sorted(MAXPOOL_SPECS))
@pytest.mark.parametrize('t', [7, 8])
def test_max_pool_3d_same(name, t):
    kernel, stride = MAXPOOL_SPECS[name]
    x = np.random.RandomState(t).randn(2, t, 9, 10, 4).astype(np.float32)
    want = np.asarray(jl.max_pool_3d_same(jnp.asarray(x), kernel, stride))
    got = from_ncthw(tl.max_pool_3d_same(to_ncthw(x), kernel, stride))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('t', [16, 15])
def test_unit1d_k3_stride2(t):
    x = np.random.RandomState(t).randn(2, t, 64).astype(np.float32)
    jm = jl.Unit1D(32, kernel=3, stride=2, activation=None)
    v = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 3)
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    tm = tl.Unit1D(64, 32, 3, 2, activation=False)
    tm.load_state_dict(port_state(v, ('pyramid', 'loc_head'),
                                  'coarse_pyramid_detection.loc_head.'))
    got = tm(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


@pytest.mark.parametrize('kernel,stride', [(3, 1), (1, 1), (3, 2)])
def test_conv_gn_relu_1d(kernel, stride):
    x = np.random.RandomState(kernel).randn(2, 12, 64).astype(np.float32)
    jm = jl.ConvGNReLU1D(64, kernel=kernel, stride=stride)
    v = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 4)
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    tm = tl.ConvGNReLU1D(64, 64, kernel, stride)
    tm.load_state_dict(port_state(v, ('pyramid', 'pyramid_2'),
                                  'coarse_pyramid_detection.pyramids.2.'))
    got = tm(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_frozen_batch_norm(dtype):
    x = np.random.RandomState(5).randn(2, 3, 4, 4, 8).astype(np.float32)
    jm = jl.FrozenBatchNorm(8)
    xj = jnp.asarray(x, jnp.bfloat16 if dtype == torch.bfloat16
                     else jnp.float32)
    v = randomize(jm.init(jax.random.PRNGKey(0), xj), 6)
    want = np.asarray(jm.apply(v, xj)).astype(np.float32)
    tm = tl.FrozenBatchNorm(8)
    tm.load_state_dict(port_state(v, ('backbone', 'U', 'bn'),
                                  'backbone._model.U.bn.'))
    got = from_ncthw(tm(to_ncthw(x).to(dtype)).float())
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, **TOL)
    else:   # x * scale + bias, both rounded to bf16 in both frameworks
        np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2)


def test_frozen_batch_norm_trainable_affine():
    bn = tl.FrozenBatchNorm(4, freeze_affine=False)
    assert {n for n, _ in bn.named_parameters()} == {'weight', 'bias'}
    assert set(bn.state_dict()) == {'weight', 'bias', 'running_mean',
                                    'running_var'}


@pytest.mark.parametrize('t_in,t_out', [(4, 16), (3, 8), (5, 7), (6, 6)])
def test_interpolate_nearest_1d(t_in, t_out):
    x = np.random.RandomState(t_in).randn(2, t_in, 3).astype(np.float32)
    want = np.asarray(jl.interpolate_nearest_1d(jnp.asarray(x), t_out))
    got = tl.interpolate_nearest_1d(torch.from_numpy(x).transpose(1, 2),
                                    t_out).transpose(1, 2).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('plus_one', [False, True])
def test_expand_boundary_segments_half_integers(plus_one):
    rng = np.random.RandomState(7)
    left = (rng.randint(-20, 40, (3, 9, 1)) / 2.0).astype(np.float32)
    right = left + (rng.randint(0, 30, (3, 9, 1)) / 2.0).astype(np.float32)
    # widths whose /4 and /10 land on .5: round-half-to-even decides
    right[0, :, 0] = left[0, :, 0] + np.array(
        [2, 6, 10, 14, 5, 15, 25, 35, 0], np.float32)
    want = np.asarray(jp.expand_boundary_segments(
        jnp.asarray(left), jnp.asarray(right), plus_one=plus_one))
    got = tp.expand_boundary_segments(torch.from_numpy(left),
                                      torch.from_numpy(right),
                                      plus_one=plus_one).numpy()
    np.testing.assert_array_equal(got, want)


def test_same_pad_amount_matches():
    for size in range(1, 12):
        for k in (1, 2, 3, 7):
            for s in (1, 2):
                assert tl.same_pad_amount(size, k, s) == \
                    jl._same_pad_amount(size, k, s)
