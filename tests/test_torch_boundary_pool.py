"""Port boundary max pool (plain PyTorch version) vs the JAX op, its
masked reference and the Pallas kernel in interpret mode, on the CPU.
The CUDA kernel itself is held against the plain version on the card by
chip_smoke.py."""

import numpy as np
import pytest
import torch

from torch_suite import suite_policy  # noqa: F401 (autouse)

import jax
import jax.numpy as jnp

from opental_tpu.ops.boundary_pool import (boundary_max_pool,
                                           boundary_max_pool_masked)
from opental_tpu.ops.boundary_pool_pallas import boundary_max_pool_interpret

from opental_torch.ops import boundary_pool as tbp
from opental_torch.ops import boundary_pool_cuda


def _segments(l, r):
    return np.stack([l[..., 0], r[..., 0], l[..., 1], r[..., 1]], -1)


def make_case(kind, seed=0, b=2, t=32, c=16, k=7):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, t, c).astype(np.float32)
    if kind == 'ties':
        # few distinct values: many windows hold their max more than once
        x = rng.randint(-2, 3, (b, t, c)).astype(np.float32)
    l = rng.randint(0, t, (b, k, 2)).astype(np.float32)
    r = l + rng.randint(0, 8, (b, k, 2)).astype(np.float32)
    if kind == 'degenerate':          # r < l: the single element at l
        r = l - rng.randint(1, 5, (b, k, 2)).astype(np.float32)
    elif kind == 'negative':          # windows partly or wholly below 0
        l = -rng.randint(1, 10, (b, k, 2)).astype(np.float32) - 0.7
        r = l + rng.randint(0, 12, (b, k, 2)).astype(np.float32)
    elif kind == 'out_of_range':      # windows past T-1
        l = t - 3 + rng.randint(0, 6, (b, k, 2)).astype(np.float32) + 0.4
        r = l + rng.randint(0, 6, (b, k, 2)).astype(np.float32)
    elif kind == 'full':
        l = np.full((b, k, 2), -5.5, np.float32)
        r = np.full((b, k, 2), t + 5.5, np.float32)
    elif kind == 'fractional':        # truncation toward zero
        l = l + rng.uniform(-0.99, 0.99, l.shape).astype(np.float32)
        r = r + rng.uniform(-0.99, 0.99, r.shape).astype(np.float32)
    return x, _segments(l, r).astype(np.float32)


KINDS = ['random', 'ties', 'degenerate', 'negative', 'out_of_range', 'full',
         'fractional']


@pytest.mark.parametrize('kind', KINDS)
def test_plain_forward_matches_jax(kind):
    x, seg = make_case(kind)
    got = tbp.boundary_max_pool_plain(torch.from_numpy(x),
                                      torch.from_numpy(seg)).numpy()
    for ref in (boundary_max_pool, boundary_max_pool_masked,
                boundary_max_pool_interpret):
        want = np.asarray(ref(jnp.asarray(x), jnp.asarray(seg)))
        np.testing.assert_allclose(got, want, rtol=0, atol=0,
                                   err_msg=ref.__name__)


@pytest.mark.parametrize('kind', ['random', 'ties', 'degenerate', 'full'])
def test_plain_backward_matches_jax_grad(kind):
    x, seg = make_case(kind, seed=1)
    g = np.random.RandomState(2).randn(
        x.shape[0], seg.shape[1], x.shape[2]).astype(np.float32)

    def loss(xx):
        return jnp.sum(boundary_max_pool(xx, jnp.asarray(seg)) * g)

    want = np.asarray(jax.grad(loss)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tbp.boundary_max_pool(xt, torch.from_numpy(seg))
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-6, atol=1e-6)


def test_bf16_forward_is_exact():
    x, seg = make_case('random', seed=3)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = tbp.boundary_max_pool(xb, torch.from_numpy(seg))
    assert got.dtype == torch.bfloat16
    want = np.asarray(boundary_max_pool_masked(
        jnp.asarray(xb.float().numpy()), jnp.asarray(seg)))
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_cpu_tensor_takes_plain_version():
    x, seg = make_case('random', seed=4)
    before = boundary_pool_cuda.LAUNCHES
    out = tbp.boundary_max_pool(torch.from_numpy(x), torch.from_numpy(seg))
    assert boundary_pool_cuda.LAUNCHES == before
    want = tbp.boundary_max_pool_plain(torch.from_numpy(x),
                                       torch.from_numpy(seg))
    assert torch.equal(out, want)
    with tbp.force_plain():
        assert tbp._FORCE_PLAIN
    assert not tbp._FORCE_PLAIN


def test_cuda_wrapper_rejects_cpu_tensors():
    """The kernel wrapper imports without CUDA, and raises (instead of
    building or falling back) when handed CPU tensors."""
    x, seg = make_case('random')
    with pytest.raises(ValueError, match='CUDA'):
        boundary_pool_cuda.boundary_max_pool_fwd(torch.from_numpy(x),
                                                 torch.from_numpy(seg))
    assert not boundary_pool_cuda._fns


@pytest.mark.parametrize('kind', ['ties', 'degenerate', 'negative',
                                  'out_of_range', 'full'])
def test_plain_backward_matches_pallas_interpret(kind):
    """The plain first-argmax backward against the Pallas `_bwd_kernel`
    (interpret mode) that kernel B2 replaces: ties go to the lowest t."""
    x, seg = make_case(kind, seed=5)
    g = np.random.RandomState(6).randn(
        x.shape[0], seg.shape[1], x.shape[2]).astype(np.float32)

    def loss(xx):
        return jnp.sum(boundary_max_pool_interpret(xx, jnp.asarray(seg))
                       * g)

    want = np.asarray(jax.grad(loss)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tbp.boundary_max_pool(xt, torch.from_numpy(seg))
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-6, atol=1e-6)


def test_plain_backward_sums_in_float32():
    """bf16 gradients are summed in float32 and rounded once, as the CUDA
    backward does."""
    argmax = torch.tensor([[[0, 1], [0, 1], [0, 0]]])
    g = torch.tensor([[[1.0, 256.0], [1.0 / 256, 1.0], [1.0 / 256, 3.0]]])
    dx = tbp.plain_backward(argmax, g.to(torch.bfloat16), 2)
    assert dx.dtype == torch.bfloat16
    # summed in bf16 step by step, 1 + 1/256 rounds back to 1 each time
    want = torch.tensor([[[1.0 + 2.0 / 256, 3.0], [0.0, 256.0]]])
    assert torch.equal(dx, want.to(torch.bfloat16))


def test_cuda_backward_wrapper_rejects_cpu_tensors():
    g = torch.zeros(1, 3, 4)
    with pytest.raises(ValueError, match='CUDA'):
        boundary_pool_cuda.boundary_max_pool_bwd(
            torch.zeros(1, 3, 4, dtype=torch.int32), g, 5)
    assert not boundary_pool_cuda._fns
