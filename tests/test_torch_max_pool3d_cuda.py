"""B6, the I3D's 3D max pool kernel (`opental_torch/csrc/max_pool3d.cu`),
against its plain version (`models/layers.max_pool_3d_same_plain`, the
TF-SAME zero pad and `F.max_pool3d`) on the card: equal on every one of
the 13 pool calls of an I3D forward (captured on the meta device) at
W = 2 and W = 128 (256 frames, 96 x 96) and at ActivityNet's 4 x 768
frames, in bfloat16 and float32, on odd extents, with NaN, +-inf,
negative values and -0.0 planted; one launch a call; and an I3D
inference forward through 13 launches equal to the plain path's. A max
is exact: the values are equal, NaN where the plain version has NaN.
This file imports neither JAX nor the JAX package, so that it also runs
where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_max_pool3d_cuda.py

Without a card its tests skip (a CUDA kernel has no CPU mode).
"""

import pytest
import torch

from opental_torch.models import i3d, layers
from opental_torch.ops import max_pool3d_cuda

CROP = 96
# (label, windows, frames): the cells' forwards and ActivityNet's batch
SHAPES = [('W=2', 2, 256), ('W=128', 128, 256), ('ANet 4 x 768', 4, 768)]
ODD = [((1, 5, 1, 3, 3), spec) for spec in max_pool3d_cuda.SPECS] + [
    ((2, 3, 3, 5, 7), spec) for spec in max_pool3d_cuda.SPECS] + [
    ((1, 7, 2, 1, 1), spec) for spec in max_pool3d_cuda.SPECS] + [
    ((3, 11, 9, 13, 11), spec) for spec in max_pool3d_cuda.SPECS]


def need_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernel has no CPU mode')


def planted(shape, dtype, seed):
    """Random values on the card, every other channel shifted below zero
    (so that the zero pad wins at the borders), with NaN, +inf, -inf and
    -0.0 planted at random places."""
    g = torch.Generator(device='cuda').manual_seed(seed)
    x = torch.randn(shape, generator=g, device='cuda', dtype=dtype)
    x[:, 1::2] -= 4
    for value, share in ((float('nan'), 1e-6), (float('inf'), 1e-6),
                         (float('-inf'), 1e-6), (-0.0, 1e-3)):
        mask = torch.rand(shape, generator=g, device='cuda') < share
        x.masked_fill_(mask, value)
    return x


def assert_same(got, want, label):
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan), label
    assert torch.equal(got.masked_fill(nan, 0), want.masked_fill(nan, 0)), \
        label


def hold(shape, kernel, stride, dtype, seed, label):
    x = planted(shape, dtype, seed)
    launches = max_pool3d_cuda.LAUNCHES
    got = max_pool3d_cuda.max_pool3d_same(x, kernel, stride)
    assert max_pool3d_cuda.LAUNCHES == launches + 1
    want = layers.max_pool_3d_same_plain(x, kernel, stride)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype, label
    assert_same(got, want, label)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('label,windows,frames', SHAPES)
def test_b6_equals_plain_on_every_call(label, windows, frames, dtype):
    need_card()
    for i, (shape, kernel, stride) in enumerate(i3d.pool_calls(windows, frames,
                                                            CROP)):
        hold(shape, kernel, stride, dtype, i, f'{label} call {i} {shape}')
        torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_b6_equals_plain_on_odd_extents(dtype):
    need_card()
    for i, (shape, (kernel, stride)) in enumerate(ODD):
        hold(shape, kernel, stride, dtype, 100 + i,
             f'{shape} {kernel} {stride}')
        # an unaligned start: the view's first element is not on 16 bytes
        x = planted((shape[0] * shape[1] + 1,) + shape[2:], dtype, 200 + i)
        x = x[1:].reshape(shape)
        want = layers.max_pool_3d_same_plain(x, kernel, stride)
        assert_same(max_pool3d_cuda.max_pool3d_same(x, kernel, stride), want,
                    f'offset {shape} {kernel} {stride}')


@pytest.mark.cuda
def test_b6_raises_on_what_it_does_not_take():
    need_card()
    x = torch.randn(1, 4, 8, 6, 6, device='cuda')
    with pytest.raises(ValueError, match='contiguous'):
        max_pool3d_cuda.max_pool3d_same(
            x.to(memory_format=torch.channels_last_3d), (3, 3, 3), (1, 1, 1))
    with pytest.raises(ValueError, match='specs'):
        max_pool3d_cuda.max_pool3d_same(x, (3, 3, 3), (1, 2, 2))
    with pytest.raises(TypeError):
        max_pool3d_cuda.max_pool3d_same(x.half(), (3, 3, 3), (1, 1, 1))


@pytest.mark.cuda
def test_i3d_inference_forward_takes_b6():
    need_card()
    torch.manual_seed(0)
    model = i3d.InceptionI3d(3, dtype=torch.bfloat16).cuda().eval()
    clips = torch.randn(2, 3, 256, CROP, CROP, device='cuda',
                        dtype=torch.bfloat16)
    launches = max_pool3d_cuda.LAUNCHES
    with torch.inference_mode():
        got = model(clips)
    assert max_pool3d_cuda.LAUNCHES == launches + 13
    real, i3d.max_pool_3d_same = (i3d.max_pool_3d_same,
                                  layers.max_pool_3d_same_plain)
    try:
        with torch.inference_mode():
            want = model(clips)
    finally:
        i3d.max_pool_3d_same = real
    assert max_pool3d_cuda.LAUNCHES == launches + 13
    for k in want:
        assert torch.equal(got[k], want[k]), k
