"""The grouped boundary max-pool CUDA kernels (`opental_torch/csrc/
boundary_pool.cu`) against the plain segmented version, on the card. The
forward only compares values, so the two are equal exactly; the backward
too, since it adds in the plain version's order (and g on a 1/64 grid
sums exactly in any order). This file imports neither JAX nor the JAX
package, so that it also runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_boundary_pool_cuda.py

Without a card its tests skip (a CUDA kernel has no CPU mode).
"""

import numpy as np
import pytest
import torch

from opental_torch.models.pyramid import level_sizes
from opental_torch.ops import boundary_pool as tbp
from opental_torch.ops import boundary_pool_cuda

PRIORS = tuple((t, t) for t in level_sizes(256))     # (64, 64) .. (2, 2)
# (levels, B, C): windows past their level on both sides, wholly outside
# it and r < l; a channel half that is no multiple of the 64-channel tile
# (plain loads, ragged tiles) and a union of rows taller than the staging
# buffer; the frame-level and packed lr problems of the pyramid at B = 2
# and B = 32 (the window and row tiles of both sizes)
CASES = {
    'four levels': (((20, 20), (10, 10), (5, 5), (1, 3)), 2, 16),
    'ragged, tall': (((300, 40), (7, 2)), 2, 130),
    'frame-level B=2': (((256, 126),), 2, 512),
    'frame-level B=32': (((256, 126),), 32, 512),
    'packed lr B=1': (PRIORS * 2, 1, 1024),
    'packed lr B=32': (PRIORS * 2, 32, 1024),
}


def adversarial(levels, b, c, seed):
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
    return (torch.from_numpy(np.concatenate(xs, 1)).cuda(),
            torch.from_numpy(np.concatenate(segs, 1)).cuda())


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(CASES))
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_grouped_kernels_match_plain_on_card(dtype, case):
    """Forward without and with the argmax, and the backward."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernels have no CPU mode')
    levels, b, c = CASES[case]
    x, seg = adversarial(levels, b, c, seed=len(case))
    x = x.to(dtype)
    want, want_am = tbp.plain_forward_segmented(x, seg, levels, True)
    out, _ = boundary_pool_cuda.boundary_max_pool_fwd(x, seg, levels=levels)
    out_t, am = boundary_pool_cuda.boundary_max_pool_fwd(x, seg, True,
                                                         levels)
    assert torch.equal(out, want) and torch.equal(out_t, want)
    assert torch.equal(am.long(), want_am)
    g = (torch.randint(-256, 257, out.shape, device='cuda') / 64).to(dtype)
    dx = boundary_pool_cuda.boundary_max_pool_bwd(am, g, x.shape[1], levels)
    assert torch.equal(dx, tbp.plain_backward_segmented(want_am, g, levels))


@pytest.mark.cuda
def test_model_op_launches_once_per_call():
    """The op the model calls launches one forward and, for a gradient,
    one backward, whatever the number of levels."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    x, seg = adversarial(PRIORS * 2, 1, 64, seed=0)
    x.requires_grad_(True)
    f0, b0 = boundary_pool_cuda.LAUNCHES, boundary_pool_cuda.BWD_LAUNCHES
    tbp.boundary_max_pool_segmented(x, seg, PRIORS * 2).sum().backward()
    torch.cuda.synchronize()
    assert (boundary_pool_cuda.LAUNCHES - f0,
            boundary_pool_cuda.BWD_LAUNCHES - b0) == (1, 1)
