"""Port stem packing (plain PyTorch versions) and the packed stem vs the
JAX package's `ops/stem_pack_pallas.py` on the CPU in float32: the v1 pack
against `stem_pack96_xla` and the v1 Pallas kernel in interpret mode, the
v2 pack against the v2 Pallas kernel in interpret mode (on the first Hp/2
rows: the JAX kernel's input carries `host_prelayout`'s H padding), both
exactly; `pack96_weights` exactly; the packed convolution at atol 1e-4
(the JAX package's own, tests/test_stem_pack.py:60) and its weight
gradient at rtol 1e-5; the stem module with the flag on against JAX's
`Stem(use_pallas=True)` at the layer tolerance. Where a JAX function
reaches Pallas, `stem_conv_v2` is patched to interpret mode for the test.
The CUDA kernel itself is held against the plain version on the card
(`test_torch_stem_pack_cuda.py`, and chip_smoke.py)."""

import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from opental_tpu.models.i3d import Stem
from opental_tpu.ops import stem_pack_pallas as jsp

from opental_torch import factory
from opental_torch.config import load_config
from opental_torch.models import layers as tl
from opental_torch.ops import stem_pack as tsp
from opental_torch.ops import stem_pack_cuda

from test_torch_layers import TOL, from_ncthw, port_state, randomize, \
    to_ncthw
from torch_suite import suite_policy  # noqa: F401 (autouse)

CONV_ATOL = 1e-4
CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'configs', 'thumos14_opental_final.yaml')


@pytest.fixture
def jax_stem_interpret(monkeypatch):
    """JAX's stem_conv_v2 in interpret mode, where the JAX model imports
    it (inside SpaceToDepthConv3d.__call__)."""
    monkeypatch.setattr(jsp, 'stem_conv_v2', functools.partial(
        jsp.stem_conv_v2, interpret=True))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def stem_weight(rng, f=5, c=3):
    """A (F, C, 7, 7, 7) weight at the stem's glorot scale."""
    lim = np.sqrt(6.0 / ((c + f) * 343))
    return rng.uniform(-lim, lim, (f, c, 7, 7, 7)).astype(np.float32)


def test_v1_matches_jax():
    xp = np.random.RandomState(0).randn(2, 20, 12, 16, 3).astype(np.float32)
    got = tsp.stem_pack96(_t(xp)).numpy()
    assert got.shape == (2, 7, 6, 8, 96)
    np.testing.assert_array_equal(got, np.asarray(
        jsp.stem_pack96_xla(jnp.asarray(xp), a_t=4)))
    np.testing.assert_array_equal(got, np.asarray(
        jsp.stem_pack96(jnp.asarray(xp), a_t=4, interpret=True)))


def test_v1_channel_order():
    """z[..., at*24 + bt*12 + bi*6 + bj*3 + c] == xp[2(u+at)+bt, 2p+bi,
    2q+bj, c], on a permuted (non-contiguous) view of a (B, C, T, H, W)
    tensor, as the model hands it over."""
    t, h, w, c = 10, 4, 6, 3
    x = np.arange(t * h * w * c, dtype=np.float32).reshape(1, t, h, w, c)
    view = _t(np.moveaxis(x, -1, 1)).permute(0, 2, 3, 4, 1)
    assert not view.is_contiguous()
    z = tsp.stem_pack96(view).numpy()
    rng = np.random.RandomState(0)
    for _ in range(40):
        u, p, q = (rng.randint(z.shape[1]), rng.randint(h // 2),
                   rng.randint(w // 2))
        at, bt, bi, bj, cc = (rng.randint(4), rng.randint(2), rng.randint(2),
                              rng.randint(2), rng.randint(c))
        assert z[0, u, p, q, at * 24 + bt * 12 + bi * 6 + bj * 3 + cc] == \
            x[0, 2 * (u + at) + bt, 2 * p + bi, 2 * q + bj, cc]


@pytest.mark.parametrize('fp', [1, 2])
@pytest.mark.parametrize('hp', [8, 10, 14])
def test_v2_matches_pallas_interpret(fp, hp):
    xp = np.random.RandomState(hp + fp).randn(2, 14, hp, 8, 3).astype(
        np.float32)
    got = tsp.stem_pack96_v2(_t(xp), fp=fp).numpy()
    want = np.asarray(jsp.stem_pack96_v2(
        jsp.host_prelayout(jnp.asarray(xp)), wq=4, fp=fp, interpret=True))
    assert got.shape == (2, 4 // fp, 96, hp // 2, fp * 4)
    np.testing.assert_array_equal(got, want[:, :, :, :hp // 2])


def test_v2_rejects_what_it_cannot_pack():
    with pytest.raises(ValueError, match='even'):
        tsp.stem_pack96_v2(torch.zeros(1, 14, 9, 8, 3))
    with pytest.raises(ValueError, match='fp'):
        tsp.stem_pack96_v2(torch.zeros(1, 16, 8, 8, 3), fp=2)   # t_out 5
    with pytest.raises(ValueError, match='too short'):
        tsp.stem_pack96(torch.zeros(1, 4, 8, 8, 3))


def test_pack96_weights_matches_jax():
    w = np.random.RandomState(1).randn(5, 3, 7, 7, 7).astype(np.float32)
    got = tsp.pack96_weights(_t(w)).numpy()
    want = np.asarray(jsp.pack96_weights(jnp.asarray(
        w.transpose(2, 3, 4, 1, 0))))                       # (4, 4, 96, F)
    assert got.shape == (5, 96, 4, 4)
    np.testing.assert_array_equal(got, want.transpose(3, 2, 0, 1))


@pytest.mark.parametrize('chunk,fp', [(0, 1), (2, 1), (0, 2), (2, 2)])
def test_stem_conv_v2_matches_jax(chunk, fp):
    """Against JAX's stem_conv_v2 (interpret mode) and the stride-2 VALID
    conv3d with the zero-padded kernel, for H that JAX pads to 8."""
    rng = np.random.RandomState(10 * chunk + fp)
    w = stem_weight(rng)
    xp = rng.uniform(-1, 1, (4, 14, 10, 12, 3)).astype(np.float32)
    kernel = jnp.asarray(w.transpose(2, 3, 4, 1, 0))
    jax_out = np.asarray(jsp.stem_conv_v2(jnp.asarray(xp), kernel, fp=fp,
                                          chunk=chunk, interpret=True))
    conv3d = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(xp), jnp.zeros((8, 8, 8, 3, 5)).at[:7, :7, :7].set(
            kernel), (2, 2, 2), 'VALID',
        dimension_numbers=('NTHWC', 'THWIO', 'NTHWC')))
    got = tsp.stem_conv_v2(_t(xp), _t(w), fp=fp, chunk=chunk)
    assert got.is_contiguous()
    got = np.moveaxis(got.numpy(), 1, -1)
    assert got.shape == conv3d.shape == jax_out.shape == (4, 4, 2, 3, 5)
    np.testing.assert_allclose(got, jax_out, rtol=0, atol=CONV_ATOL)
    np.testing.assert_allclose(got, conv3d, rtol=0, atol=CONV_ATOL)


@pytest.mark.parametrize('shape', [(4, 16, 12, 10, 3), (1, 14, 8, 14, 3)])
def test_stem_conv_v1_equals_v2(shape):
    """The channels-last route computes the same convolution."""
    rng = np.random.RandomState(3)
    w = _t(stem_weight(rng))
    xp = _t(rng.uniform(-1, 1, shape).astype(np.float32))
    torch.testing.assert_close(tsp.stem_conv_v1(xp, w),
                               tsp.stem_conv_v2(xp, w), rtol=0,
                               atol=CONV_ATOL)


@pytest.mark.parametrize('layout,fp', [('v2', 1), ('v2', 2), ('v1', 1)])
def test_stem_weight_gradient_matches_jax_grad(layout, fp):
    """autograd through pack96_weights and the 2D conv == jax.grad of the
    same contraction (the pack itself has no gradient: the video is
    data), at rtol 1e-5 plus 1e-5 of the largest entry (entries near 0 are
    sums that cancel)."""
    rng = np.random.RandomState(4 + fp)
    w = stem_weight(rng)
    xp = rng.uniform(-1, 1, (2, 14, 10, 12, 3)).astype(np.float32)
    g = rng.randn(2, 4, 2, 3, 5).astype(np.float32)       # (B, t, h, w, F)

    def loss(kernel):
        return jnp.sum(jsp.stem_conv_v2(jnp.asarray(xp), kernel, fp=fp,
                                        interpret=True) * g)

    want = np.asarray(jax.grad(loss)(jnp.asarray(w.transpose(2, 3, 4, 1,
                                                             0))))
    wt = _t(w).requires_grad_(True)
    y = (tsp.stem_conv_v2(_t(xp), wt, fp=fp) if layout == 'v2'
         else tsp.stem_conv_v1(_t(xp), wt))
    (y * _t(np.moveaxis(g, -1, 1))).sum().backward()
    np.testing.assert_allclose(wt.grad.numpy(), want.transpose(4, 3, 0, 1, 2),
                               rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize('t,h', [(10, 12), (9, 11)])
def test_stem_module_flag_on(jax_stem_interpret, t, h):
    """Unit3D(space_to_depth=True) == JAX Stem(use_pallas=True), and ==
    the port's plain stride-2 stem, on the same weights; odd extents take
    the extra trailing zero."""
    rng = np.random.RandomState(t)
    x = rng.randn(1, t, h, h + 2, 3).astype(np.float32)
    jm = Stem(16, use_pallas=True)
    v = randomize(jm.init(jax.random.PRNGKey(1), jnp.asarray(x)), 2)
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    state = port_state(v, ('backbone', 'Conv3d_1a_7x7'),
                       'backbone._model.Conv3d_1a_7x7.')
    tm = tl.Unit3D(3, 16, (7, 7, 7), (2, 2, 2), space_to_depth=True)
    tm.load_state_dict(state)
    got = from_ncthw(tm(to_ncthw(x)))
    np.testing.assert_allclose(got, want, **TOL)
    plain = tl.Unit3D(3, 16, (7, 7, 7), (2, 2, 2))
    plain.load_state_dict(state)
    np.testing.assert_allclose(got, from_ncthw(plain(to_ncthw(x))), **TOL)


def test_factory_reads_stem_pallas():
    """model.stem_pallas turns the packed stem on; the state_dict (keys
    and shapes) is the flag-off model's."""
    off = factory.build_model(load_config(CONFIG), frame_num=64,
                              crop_size=32)
    on = factory.build_model(load_config(CONFIG, overrides={
        'model.stem_pallas': True}), frame_num=64, crop_size=32)
    stem = on.backbone._model.Conv3d_1a_7x7
    assert stem.space_to_depth
    assert not off.backbone._model.Conv3d_1a_7x7.space_to_depth
    assert {k: v.shape for k, v in on.state_dict().items()} == \
        {k: v.shape for k, v in off.state_dict().items()}
    assert stem.conv3d.weight.shape == (64, 3, 7, 7, 7)


def test_cpu_tensor_takes_plain_version():
    xp = torch.randn(1, 10, 4, 6, 3)
    before = (stem_pack_cuda.V1_LAUNCHES, stem_pack_cuda.V2_LAUNCHES)
    assert torch.equal(tsp.stem_pack96(xp), tsp.stem_pack96_plain(xp))
    assert torch.equal(tsp.stem_pack96_v2(xp), tsp.stem_pack96_v2_plain(xp))
    assert (stem_pack_cuda.V1_LAUNCHES, stem_pack_cuda.V2_LAUNCHES) == before
    with tsp.force_plain():
        assert tsp._FORCE_PLAIN
    assert not tsp._FORCE_PLAIN


def test_cuda_wrapper_rejects_cpu_tensors():
    """The kernel wrapper imports without CUDA, and raises (instead of
    building or falling back) when handed a CPU tensor."""
    xp = torch.zeros(1, 10, 4, 6, 3)
    with pytest.raises(ValueError, match='CUDA'):
        stem_pack_cuda.stem_pack96(xp)
    with pytest.raises(ValueError, match='CUDA'):
        stem_pack_cuda.stem_pack96_v2(xp)
    assert not stem_pack_cuda._fns


def _bcthw_view(shape, seed):
    """(B, Tp, Hp, Wp, C) as the model hands it over: a permuted view of
    a contiguous (B, C, Tp, Hp, Wp) tensor."""
    b, t, h, w, c = shape
    x = np.random.RandomState(seed).randn(b, c, t, h, w).astype(np.float32)
    return _t(x).permute(0, 2, 3, 4, 1)


@pytest.mark.parametrize('contiguous', [False, True])
@pytest.mark.parametrize('layout,fp', [('v1', 1), ('v2', 1), ('v2', 2)])
def test_strided_copy_equals_plain(layout, fp, contiguous):
    """The library yardstick (one `.contiguous()` of a strided view of
    xp) is the pack, exactly, on the model's permuted view and on a
    contiguous input."""
    xp = _bcthw_view((2, 18, 12, 16, 3), 5)
    if contiguous:
        xp = xp.contiguous()
    got = tsp.stem_pack_strided(xp, fp=fp, layout=layout)
    want = (tsp.stem_pack96_plain(xp) if layout == 'v1'
            else tsp.stem_pack96_v2_plain(xp, fp=fp))
    assert got.is_contiguous()
    assert torch.equal(got, want)


def test_strided_copy_rejects_what_it_cannot_pack():
    xp = torch.zeros(1, 16, 8, 8, 3)                         # t_out 5
    with pytest.raises(ValueError, match='fp'):
        tsp.stem_pack_strided(xp, fp=2)
    with pytest.raises(ValueError, match='layout'):
        tsp.stem_pack_strided(xp, fp=2, layout='v1')


@pytest.mark.parametrize('case,fp,layout,want', [
    ('model view', 1, 1, 'frame_bulk'),
    ('contiguous', 1, 1, 'frame_strided'),
    ('W sliced', 1, 1, 'frame_strided'),
    ('model view', 2, 1, 'tile'),
    ('model view', 1, 0, 'tile'),
])
def test_kernel_plan_follows_layout_and_strides(case, fp, layout, want):
    """The wrapper's choice of design: bulk copies only where a band of
    rows of one plane is contiguous (unit W stride, packed rows)."""
    xp = _bcthw_view((1, 14, 8, 10, 3), 0)
    if case == 'contiguous':
        xp = xp.contiguous()
    elif case == 'W sliced':
        xp = _bcthw_view((1, 14, 8, 12, 3), 0)[:, :, :, 1:11]
    assert stem_pack_cuda.plan(xp, fp, layout) == want
