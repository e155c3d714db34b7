"""The stem-pack CUDA kernel (`opental_torch/csrc/stem_pack.cu`) against
its plain PyTorch version, on the card. The kernel only moves values,
so the two are equal exactly. This file imports neither JAX nor the JAX
package, so that it also runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_stem_pack_cuda.py

Without a card its tests skip (a CUDA kernel has no CPU mode).
"""

import pytest
import torch

from opental_torch.ops import stem_pack as tsp
from opental_torch.ops import stem_pack_cuda


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_card(dtype):
    """Both layouts, fp 1 and 2, contiguous and permuted inputs, Hp not a
    multiple of 8 and Wp != Hp."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernel has no CPU mode')
    g = torch.Generator(device='cuda').manual_seed(0)
    for shape in ((2, 18, 12, 16, 3), (3, 22, 10, 14, 3)):
        x = torch.randn(shape, generator=g, device='cuda').to(dtype)
        view = x.permute(0, 4, 1, 2, 3).contiguous().permute(0, 2, 3, 4, 1)
        for xp in (x, view):
            assert torch.equal(stem_pack_cuda.stem_pack96(xp),
                               tsp.stem_pack96_plain(xp))
            for fp in (1, 2):
                assert torch.equal(stem_pack_cuda.stem_pack96_v2(xp, fp=fp),
                                   tsp.stem_pack96_v2_plain(xp, fp=fp))


# (B, Tp, Hp, Wp, C), storage offset of the (B, C, Tp, Hp, Wp) tensor
FRAME_CASES = {
    'one band': ((2, 18, 12, 16, 3), 0),
    'plane in bands (Hp = Wp = 230)': ((2, 10, 230, 230, 3), 0),
    't_out = 1': ((2, 8, 10, 14, 3), 0),
    'odd plane, offset 1': ((3, 22, 10, 14, 3), 1),
    'B > 1, Wp != Hp': ((4, 12, 26, 38, 3), 0),
}


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(FRAME_CASES))
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_frame_plan_matches_plain_on_card(dtype, case):
    """Every path of B4's frame plan (bulk copies on the model's view,
    strided loads on a contiguous input), and the tile plan of v1 and
    fp = 2, on the same inputs: planes too large for shared memory in
    one piece, the first and last frames (fewer than a_t destinations),
    runs and input planes that start off 16-byte alignment, B > 1."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernel has no CPU mode')
    (b, t, h, w, c), offset = FRAME_CASES[case]
    g = torch.Generator(device='cuda').manual_seed(1)
    buf = torch.randn(b * c * t * h * w + offset, generator=g,
                      device='cuda').to(dtype)
    view = buf[offset:].view(b, c, t, h, w).permute(0, 2, 3, 4, 1)
    want = tsp.stem_pack96_v2_plain(view)
    for xp, path in ((view, 'frame_bulk'),
                     (view.contiguous(), 'frame_strided')):
        assert stem_pack_cuda.plan(xp, 1, 1) == path
        assert torch.equal(stem_pack_cuda.stem_pack96_v2(xp), want)
        if (t // 2 - 3) % 2 == 0:
            assert torch.equal(stem_pack_cuda.stem_pack96_v2(xp, fp=2),
                               tsp.stem_pack96_v2_plain(xp, fp=2))
        assert torch.equal(stem_pack_cuda.stem_pack96(xp),
                           tsp.stem_pack96_plain(xp))


@pytest.mark.cuda
def test_kernel_refuses_what_it_cannot_take():
    """A tensor that needs a gradient, an odd extent or an unsupported
    dtype raises before any launch."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    before = (stem_pack_cuda.V1_LAUNCHES, stem_pack_cuda.V2_LAUNCHES)
    x = torch.zeros((1, 14, 8, 8, 3), device='cuda')
    with pytest.raises(ValueError, match='gradient'):
        stem_pack_cuda.stem_pack96(x.clone().requires_grad_(True))
    with pytest.raises(ValueError, match='even'):
        stem_pack_cuda.stem_pack96_v2(x[:, :, :7])
    with pytest.raises(TypeError, match='float32 or bfloat16'):
        stem_pack_cuda.stem_pack96(x.half())
    with pytest.raises(ValueError, match='fp'):
        stem_pack_cuda.stem_pack96_v2(torch.zeros((1, 16, 8, 8, 3),
                                                  device='cuda'), fp=2)
    assert (stem_pack_cuda.V1_LAUNCHES, stem_pack_cuda.V2_LAUNCHES) == before


# the flow stream of two-stream fusion: C = 2, so z has 64 channels and
# the destination runs sit at other 16-byte offsets than at C = 3
FLOW_CASES = {
    'flow clip as the model hands it over (B, 262, 102, 102, 2)':
        (2, 262, 102, 102, 2),
    'odd plane': (3, 22, 10, 14, 2),
}


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(FLOW_CASES))
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_flow_stream_pack_matches_plain_on_card(dtype, case):
    """B4 (and v1, fp 2) at C = 2 on the flow model's permuted view and a
    contiguous copy, exactly."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernel has no CPU mode')
    b, t, h, w, c = FLOW_CASES[case]
    g = torch.Generator(device='cuda').manual_seed(2)
    view = torch.randn((b, c, t, h, w), generator=g, device='cuda').to(
        dtype).permute(0, 2, 3, 4, 1)
    want = tsp.stem_pack96_v2_plain(view)
    assert want.shape[2] == 64
    for xp in (view, view.contiguous()):
        assert torch.equal(stem_pack_cuda.stem_pack96_v2(xp), want)
        assert torch.equal(stem_pack_cuda.stem_pack96(xp),
                           tsp.stem_pack96_plain(xp))
        if (t // 2 - 3) % 2 == 0:
            assert torch.equal(stem_pack_cuda.stem_pack96_v2(xp, fp=2),
                               tsp.stem_pack96_v2_plain(xp, fp=2))
