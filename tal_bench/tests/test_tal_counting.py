"""The yardstick's arithmetic against hand counts at small shapes."""

import math

import pytest
import torch
import torch.nn.functional as F

from tal_bench import counting


def test_conv_and_matmul_flops_by_hand():
    x = torch.zeros((2, 3, 8, 10, 10), device='meta')
    w = torch.zeros((5, 3, 3, 3, 3), device='meta')
    a = torch.zeros((4, 6), device='meta')
    b = torch.zeros((6, 7), device='meta')
    with counting.FlopCounter() as c:
        y = F.conv3d(x, w, stride=(1, 2, 2))
        torch.mm(a, b)
    # output (2, 5, 6, 4, 4), each 3 * 27 products
    assert y.shape == (2, 5, 6, 4, 4)
    assert c.flops == 2 * (2 * 5 * 6 * 4 * 4) * 3 * 27 + 2 * 4 * 6 * 7


def test_conv_backward_counts_both_gradients():
    x = torch.zeros((1, 2, 6), device='meta', requires_grad=True)
    w = torch.zeros((4, 2, 3), device='meta', requires_grad=True)
    fwd = 2 * (1 * 4 * 4) * 2 * 3
    with counting.FlopCounter() as c:
        F.conv1d(x, w).sum().backward()
    assert c.flops == 3 * fwd
    x2 = torch.zeros((1, 2, 6), device='meta')
    with counting.FlopCounter() as c2:
        F.conv1d(x2, w).sum().backward()
    assert c2.flops == 2 * fwd


def test_model_flops_scale_with_batch():
    cfg = {'dataset': {'num_classes': 16}, 'model': {'os_head': True,
                                                      'use_edl': True}}
    one = counting.model_flops(cfg, 128, 32, 1, train=False)
    two = counting.model_flops(cfg, 128, 32, 2, train=False)
    assert one > 0 and two == 2 * one


def test_pool_bytes_by_hand():
    # one level of T = 10 rows, C = 4 (halves of 2): window [2, 4] on
    # the start half and [3, 3] on the end half; a second window [0, 1]
    # and [8, 12] (clamped to 9)
    seg = torch.tensor([[[2.0, 4.0, 3.0, 3.0], [0.0, 1.0, 8.0, 12.0]]])
    nbytes = counting.pool_fwd_bytes((1, 10, 4), 2, seg, None, False)
    rows = (3 + 2) + (1 + 2)           # covered rows per half, b = 1
    assert nbytes == rows * 2 * 2 + seg.numel() * 4 + 1 * 2 * 4 * 2
    with_arg = counting.pool_fwd_bytes((1, 10, 4), 2, seg, None, True)
    assert with_arg == nbytes + 1 * 2 * 4 * 4
    assert counting.pool_bwd_bytes((1, 2, 4), 4, 10) == \
        1 * 2 * 4 * (4 + 4) + 1 * 10 * 4 * 4


def test_levels_keep_windows_on_their_rows():
    seg = torch.tensor([[[0.0, 9.0, 0.0, 9.0], [0.0, 9.0, 0.0, 9.0]]])
    both = counting.pool_fwd_bytes((1, 8, 2), 4, seg, ((5, 1), (3, 1)),
                                   False)
    # 5 and 3 covered rows in each of the 2 halves, 1 channel, float32
    assert both == (5 + 3) * 2 * 1 * 4 + seg.numel() * 4 + 2 * 2 * 4


@pytest.mark.parametrize('backward', [False, True])
def test_share_is_100_when_the_kernel_takes_its_bound(backward):
    seg = torch.tensor([[[1.0, 5.0, 2.0, 3.0]]])
    if backward:
        calls = [{'g_shape': (2, 3, 8), 'itemsize': 4, 't_len': 16}] * 3
        least = counting.least_seconds(counting.pool_bwd_bytes(
            (2, 3, 8), 4, 16))
    else:
        calls = [{'x_shape': (1, 8, 4), 'itemsize': 2, 'segments': seg,
                  'levels': None, 'with_argmax': True}] * 3
        least = counting.least_seconds(counting.pool_fwd_bytes(
            (1, 8, 4), 2, seg, None, True))
    share = counting.pool_roofline_pct(calls, [least] * 3, backward)
    assert math.isclose(share, 100.0, rel_tol=1e-12)
    assert counting.pool_roofline_pct(calls, [2 * least] * 3,
                                      backward) == pytest.approx(50.0)
    assert counting.pool_roofline_pct(calls, [least] * 2, backward) is None


def test_mfu_is_100_at_the_peak():
    peak = counting.PEAK_FLOPS['bf16']
    assert counting.mfu_pct(10, int(peak / 10), 1.0, 'bf16') == \
        pytest.approx(100.0)
    assert counting.mfu_pct(0, 1, 1.0, 'bf16') is None
