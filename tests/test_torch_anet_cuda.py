"""The grouped boundary max-pool kernels (`opental_torch/csrc/
boundary_pool.cu`, B1 forward and B2 backward) at the ActivityNet
pyramid's problems, against the plain segmented version on the card.

Full-width shapes: the frame-level pool (T = 768 rows, 189 windows,
C = 512), where a window of the coarsest level can cover every row and
the staging buffer takes many passes, and the lr pool (12 levels of 96
.. 3 rows, C = 1024), at the inference batch (4) and the train batch (2),
in float32 and bfloat16; windows as the stride-scaled offsets give them
(far past their level, wholly outside it, r < l) and bounds of +-1e10,
+-inf and NaN, which the kernel's __float2int_rz and the plain version
both saturate (NaN -> 0). Both must be equal exactly. This file imports
neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_anet_cuda.py

Without a card its tests skip (a CUDA kernel has no CPU mode).
"""

import numpy as np
import pytest
import torch

from opental_torch.models.bdnet import BDNet
from opental_torch.ops import boundary_pool as tbp
from opental_torch.ops import boundary_pool_cuda

SIZES = (96, 48, 24, 12, 6, 3)
PROBLEMS = {
    'frame-level': (((768, 189),), 512),
    'lr': (tuple((t, t) for t in SIZES) * 2, 1024),
}
EXTREMES = np.asarray([1e10, -1e10, np.inf, -np.inf, np.nan, 3e9],
                      np.float32)


def anet_case(levels, c, b, seed, extreme):
    rng = np.random.RandomState(seed)
    xs, segs = [], []
    for t, k in levels:
        xs.append(rng.randn(b, t, c).astype(np.float32))
        l = rng.uniform(-2 * t, 2 * t, (b, k, 2))
        r = l + rng.uniform(-4, 2 * t, (b, k, 2))
        seg = np.stack([l[..., 0], r[..., 0], l[..., 1], r[..., 1]],
                       -1).astype(np.float32)
        seg[:, ::7] = [-0.5, t + 300.0, -200.0, t - 0.5]   # whole level
        if extreme:
            hit = rng.rand(*seg.shape) < 0.3
            seg[hit] = rng.choice(EXTREMES, int(hit.sum()))
        segs.append(seg)
    return (torch.from_numpy(np.concatenate(xs, 1)).cuda(),
            torch.from_numpy(np.concatenate(segs, 1)).cuda())


def need_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernels have no CPU mode')


@pytest.mark.cuda
@pytest.mark.parametrize('problem', sorted(PROBLEMS))
@pytest.mark.parametrize('b', [2, 4])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('extreme', [False, True])
def test_kernels_match_plain_at_anet_shapes(problem, b, dtype, extreme):
    need_card()
    levels, c = PROBLEMS[problem]
    x, seg = anet_case(levels, c, b, seed=b + 7 * extreme, extreme=extreme)
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
def test_anet_forward_launches_two_pools():
    """An ANet BDNet forward on the card (frame 768, crop 96) launches B1
    twice and gives the plain path's output."""
    need_card()
    model = BDNet(num_classes=5, os_head=True, use_edl=True, frame_num=768,
                  crop_size=96, arch='anet').cuda().eval()
    x = torch.rand(1, 3, 768, 96, 96, device='cuda') * 2 - 1
    f0 = boundary_pool_cuda.LAUNCHES
    with torch.inference_mode():
        out = model(x)
        torch.cuda.synchronize()
        assert boundary_pool_cuda.LAUNCHES - f0 == 2
        with tbp.force_plain():
            want = model(x)
    for k in ('loc', 'conf', 'prop_loc', 'prop_conf', 'center'):
        torch.testing.assert_close(out[k], want[k], rtol=1e-4, atol=1e-4)
