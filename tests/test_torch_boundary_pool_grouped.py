"""The segmented (grouped) boundary max pool of the port against the JAX
op applied level by level, on the CPU, and the pyramid's pooling as one
call per problem. The grouped CUDA kernels are held against the plain
segmented version on the card by tests/test_torch_boundary_pool_cuda.py
and chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from opental_tpu.ops.boundary_pool import boundary_max_pool

from opental_torch.models import bdnet as tb
from opental_torch.models import pyramid as tpyr
from opental_torch.ops import boundary_pool as tbp
from opental_torch.ops import boundary_pool_cuda

from test_torch_boundary_pool import KINDS, make_case
from torch_suite import suite_policy  # noqa: F401 (autouse)

# (t_i, k_i): the pyramid's prop problem at frame_num 128 has (32, 32),
# (16, 16), ..., (1, 1); these mix k != t and a level without windows
LEVELS = ((32, 7), (16, 9), (0, 0), (8, 5), (3, 4))


def _packed(kind, levels=LEVELS, b=2, c=16, seed=0):
    xs, segs = [], []
    for i, (t, k) in enumerate(levels):
        if t:
            x, seg = make_case(kind, seed=seed + i, b=b, t=t, c=c, k=k)
        else:
            x, seg = (np.zeros((b, 0, c), np.float32),
                      np.zeros((b, 0, 4), np.float32))
        xs.append(x)
        segs.append(seg)
    return xs, segs


def _adversarial(levels, b=2, c=16, seed=0):
    """Windows that reach past their level on both sides, lie wholly
    outside it, or have r < l, on every level."""
    rng = np.random.RandomState(seed)
    xs, segs = [], []
    for t, k in levels:
        xs.append(rng.randn(b, t, c).astype(np.float32))
        l = rng.randint(-t - 3, 2 * t + 3, (b, k, 2)).astype(np.float32)
        r = l + rng.randint(-4, t + 4, (b, k, 2))
        seg = np.stack([l[..., 0], r[..., 0], l[..., 1], r[..., 1]], -1)
        seg = seg + rng.uniform(-0.99, 0.99, seg.shape)
        seg[:, ::3] = [-2.5 * t, -t - 0.5, t + 1.5, 3.0 * t]   # outside
        segs.append(seg.astype(np.float32))
    return xs, segs


def _jax_per_level(xs, segs):
    return np.concatenate([np.asarray(boundary_max_pool(
        jnp.asarray(x), jnp.asarray(s))) for x, s in zip(xs, segs)
        if s.shape[1]], 1)


def _torch(xs, segs):
    return (torch.from_numpy(np.concatenate(xs, 1)),
            torch.from_numpy(np.concatenate(segs, 1)))


@pytest.mark.parametrize('kind', KINDS)
def test_segmented_plain_forward_matches_jax_per_level(kind):
    xs, segs = _packed(kind)
    x, seg = _torch(xs, segs)
    got = tbp.boundary_max_pool_segmented(x, seg, LEVELS).numpy()
    np.testing.assert_array_equal(got, _jax_per_level(xs, segs))


@pytest.mark.parametrize('seed', [0, 1])
def test_segmented_windows_stay_in_their_level(seed):
    levels = ((20, 20), (10, 10), (5, 5), (1, 3))
    xs, segs = _adversarial(levels, seed=seed)
    x, seg = _torch(xs, segs)
    np.testing.assert_array_equal(
        tbp.boundary_max_pool_segmented(x, seg, levels).numpy(),
        _jax_per_level(xs, segs))
    _, argmax = tbp.plain_forward_segmented(x, seg, levels, True)
    lo = np.repeat([0, 20, 30, 35], [t for _, t in levels])
    hi = np.repeat([20, 30, 35, 36], [t for _, t in levels])
    a = argmax.numpy()
    assert ((a >= lo[None, :, None]) & (a < hi[None, :, None])).all()


@pytest.mark.parametrize('kind', ['random', 'ties', 'degenerate', 'full',
                                  'adversarial'])
def test_segmented_plain_backward_matches_jax_grad(kind):
    if kind == 'adversarial':
        levels = ((20, 20), (10, 10), (5, 5), (1, 3))
        xs, segs = _adversarial(levels, seed=3)
    else:
        levels = LEVELS
        xs, segs = _packed(kind, seed=1)
    x, seg = _torch(xs, segs)
    g = np.random.RandomState(2).randn(*seg.shape[:2], x.shape[2]).astype(
        np.float32)
    bounds = np.cumsum([0] + [t for t, _ in levels])

    def loss(xx):
        out = jnp.concatenate([
            boundary_max_pool(xx[:, lo:hi], jnp.asarray(s))
            for lo, hi, s in zip(bounds[:-1], bounds[1:], segs)
            if s.shape[1]], 1)
        return jnp.sum(out * g)

    want = np.asarray(jax.grad(loss)(jnp.asarray(x.numpy())))
    xt = x.clone().requires_grad_(True)
    out = tbp.boundary_max_pool_segmented(xt, seg, levels)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-6, atol=1e-6)


def test_roi_call_equals_per_level_calls():
    """The pyramid's frame-level pool: one call with the 6 levels' 126
    windows on the (B, 256, C) frame feature equals the 6 per-level
    calls, forward and gradient."""
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(2, 256, 8).astype(np.float32))
    loc = torch.from_numpy(rng.uniform(0, 40, (2, 126, 2)).astype(
        np.float32))
    segs, k0 = [], 0
    for t in tpyr.level_sizes(256):
        segs.append(tpyr.proposal_segments(loc[:, k0:k0 + t], 256)[1])
        k0 += t
    assert k0 == 126
    xa = x.clone().requires_grad_(True)
    got = tbp.boundary_max_pool_segmented(xa, torch.cat(segs, 1),
                                          ((256, 126),))
    xb = x.clone().requires_grad_(True)
    want = torch.cat([tbp.boundary_max_pool(xb, s) for s in segs], 1)
    assert torch.equal(got, want)
    g = torch.from_numpy(rng.randn(2, 126, 8).astype(np.float32))
    (got * g).sum().backward()
    (want * g).sum().backward()
    torch.testing.assert_close(xa.grad, xb.grad, rtol=1e-6, atol=1e-6)


def _count_pools(monkeypatch):
    calls = []
    real = tbp.boundary_max_pool_segmented

    def counting(x, seg, levels):
        calls.append(levels)
        return real(x, seg, levels)
    monkeypatch.setattr(tpyr, 'boundary_max_pool_segmented', counting)
    monkeypatch.setattr(tb, 'boundary_max_pool_segmented', counting)
    return calls


def test_pyramid_pools_once_per_problem(monkeypatch):
    """frame_num 128: one forward makes 2 pool calls (the frame-level pool
    of all 6 levels, and the 12 lr levels of both branches), where the
    per-level design made 24; the SSL pass makes none and returns the
    same features; the SSL triplets take 2 calls."""
    torch.manual_seed(0)
    model = tb.BDNet(num_classes=16, os_head=True, use_edl=True,
                     frame_num=128, crop_size=32).eval()
    clip = torch.from_numpy(np.random.RandomState(0).uniform(
        -1, 1, (1, 3, 128, 32, 32)).astype(np.float32))
    calls = _count_pools(monkeypatch)
    with torch.no_grad():
        feats = model.backbone(clip)
        out = model.coarse_pyramid_detection(feats)
        assert len(calls) == 2 <= 3
        sizes = tpyr.level_sizes(128)
        assert calls == [((128, 63),), tuple((t, t) for t in sizes) * 2]
        del calls[:]
        trip = model.coarse_pyramid_detection(feats, ssl=True)['trip']
        assert calls == []
        for got, key in zip(trip, ('', '_loc_prop', '_conf_prop')):
            want = torch.cat([out['start' + key], out['end' + key]], -1)
            assert torch.equal(got, want), key
        proposals = torch.tensor([[[10., 40.], [60., 100.], [45., 55.]]])
        anchor, positive, negative = tb.BDNet._ssl_triplets(trip, proposals)
    assert len(calls) == 2
    # the triplets against one single-level call per feature
    seg = tpyr.expand_boundary_segments(proposals[..., :1],
                                        proposals[..., 1:], plus_one=True)
    for i, (feat, scale) in enumerate(zip(trip, tb.SSL_SCALES)):
        bound = tbp.boundary_max_pool_plain(feat.contiguous(), seg / scale)
        nd = bound.shape[-1] // 2
        assert torch.equal(anchor[i], bound[:, 0, nd:])
        assert torch.equal(positive[i], bound[:, 1, :nd])
        assert torch.equal(negative[i], bound[:, 2, :nd])


@pytest.mark.parametrize('levels, t_total, k_total', [
    (((4, 2), (3, 3)), 8, 5),        # rows do not sum to T
    (((4, 2), (3, 3)), 7, 6),        # windows do not sum to K
    (((0, 2), (7, 3)), 7, 5),        # windows without rows
    (((8, 5),) * 17, 136, 85),       # more levels than the kernel takes
    ((), 0, 0),
])
def test_bad_level_tables_raise(levels, t_total, k_total):
    with pytest.raises(ValueError):
        boundary_pool_cuda.check_levels(levels, t_total, k_total)
    x = torch.zeros((1, t_total, 4))
    with pytest.raises(ValueError):
        tbp.boundary_max_pool_segmented(x, torch.zeros((1, k_total, 4)),
                                        levels)


def test_segmented_cuda_wrappers_reject_cpu_tensors():
    xs, segs = _packed('random')
    x, seg = _torch(xs, segs)
    with pytest.raises(ValueError, match='CUDA'):
        boundary_pool_cuda.boundary_max_pool_fwd(x, seg, True, LEVELS)
    with pytest.raises(ValueError, match='CUDA'):
        boundary_pool_cuda.boundary_max_pool_bwd(
            torch.zeros(seg.shape[:2] + (16,), dtype=torch.int32),
            torch.zeros(seg.shape[:2] + (16,)), x.shape[1], LEVELS)
    assert not boundary_pool_cuda._fns
