"""The boundary max pool at the ActivityNet pyramid's problems, on the
CPU: the port's plain segmented version against the JAX op level by
level, with windows far out of range.

ANet multiplies each level's offsets by its FPN stride (up to 128)
before they set the pooling windows, so a window's float bounds can land
anywhere, overflow to +-inf, or be NaN where a logit overflowed. Held at
the small size (frame 256: the frame-level problem (256, 63) and the lr
problem of 12 levels of 32 .. 1 rows), with bounds of +-1e10, +-inf and
NaN mixed into ordinary ones: forward and gradient exactly equal to the
JAX op's (its astype(int32) saturates, NaN -> 0; so do the port's plain
version and the CUDA kernel's __float2int_rz, which
`tests/test_torch_anet_cuda.py` and chip_smoke.py hold on the card).
"""

import numpy as np
import pytest
import torch

from torch_suite import suite_policy  # noqa: F401 (autouse)

import jax
import jax.numpy as jnp

from opental_tpu.ops.boundary_pool import boundary_max_pool

from opental_torch.ops import boundary_pool as tbp

SIZES = (32, 16, 8, 4, 2, 1)
PROBLEMS = {
    'frame-level': (((256, 63),), 64),
    'lr': (tuple((t, t) for t in SIZES) * 2, 32),
}
EXTREMES = np.asarray([1e10, -1e10, np.inf, -np.inf, np.nan, 3e9, -3e9],
                      np.float32)


def extreme_case(levels, c, seed, b=2):
    """x per level and segments (ordinary windows in level units, with a
    third of the bounds replaced by extreme values)."""
    rng = np.random.RandomState(seed)
    xs, segs = [], []
    for t, k in levels:
        xs.append(rng.randn(b, t, c).astype(np.float32))
        l = rng.uniform(-t, 2 * t, (b, k, 2))
        r = l + rng.uniform(-3, t, (b, k, 2))
        seg = np.stack([l[..., 0], r[..., 0], l[..., 1], r[..., 1]],
                       -1).astype(np.float32)
        hit = rng.rand(*seg.shape) < 0.35
        seg[hit] = rng.choice(EXTREMES, int(hit.sum()))
        segs.append(seg)
    return xs, segs


@pytest.mark.parametrize('problem', sorted(PROBLEMS))
@pytest.mark.parametrize('seed', [0, 1])
def test_extreme_windows_match_jax(problem, seed):
    levels, c = PROBLEMS[problem]
    xs, segs = extreme_case(levels, c, seed)
    assert any(np.isinf(s).any() and np.isnan(s).any() for s in segs)
    x = torch.from_numpy(np.concatenate(xs, 1))
    seg = torch.from_numpy(np.concatenate(segs, 1))
    g = np.random.RandomState(9).randn(*seg.shape[:2], c).astype(np.float32)
    bounds = np.cumsum([0] + [t for t, _ in levels])

    def jax_out(xx):
        return jnp.concatenate([
            boundary_max_pool(xx[:, lo:hi], jnp.asarray(s))
            for lo, hi, s in zip(bounds[:-1], bounds[1:], segs)], 1)

    xj = jnp.asarray(x.numpy())
    want = np.asarray(jax_out(xj))
    want_dx = np.asarray(jax.grad(lambda xx: jnp.sum(jax_out(xx) * g))(xj))
    xt = x.clone().requires_grad_(True)
    got = tbp.boundary_max_pool_segmented(xt, seg, levels)
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), want)
    np.testing.assert_allclose(xt.grad.numpy(), want_dx, rtol=1e-6,
                               atol=1e-6)


def test_conversion_saturates():
    """+1e10 and +inf take the level's last row, -1e10 and -inf its
    first, NaN row 0, as the JAX op and the kernel convert them."""
    seg = torch.tensor([[[1e10, float('inf'), -1e10, float('-inf')],
                         [float('nan'), 1e10, 5.7, -5.7]]])
    l, r = tbp.clamp_windows(seg, 96)
    assert l.tolist() == [[[95, 0], [0, 5]]]
    assert r.tolist() == [[[95, 0], [95, 5]]]
