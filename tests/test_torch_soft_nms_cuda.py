"""The soft-NMS kernel (`opental_torch/csrc/soft_nms.cu`) against the plain
loop (`ops/nms.soft_nms_plain`) on the card: every row's kept flags and
picks exactly, the scores to rtol 1e-6 (both take the same float32
operations in the same order), in registers up to `REGISTER_N`
candidates a row and in the output past it. `soft_nms_device` takes the
kernel for every CUDA block, once a call, without a synchronisation,
and counts `nms.steps` as the longest row's picks. This file imports neither JAX
nor the JAX package, so that it also runs where only the port is
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_soft_nms_cuda.py

Without a card its tests skip (a CUDA kernel has no CPU mode).
"""

import numpy as np
import pytest
import torch

from opental_torch.infer import post
from opental_torch.infer.decode import DecodedWindows
from opental_torch.infer.pipeline import InferencePipeline
from opental_torch.ops import nms, soft_nms_cuda
from opental_torch.utils import profiling


def saturated(rows, n, d, seed, video_s=200.0):
    """(rows, n, d) candidates as the inference cells load soft-NMS: every
    one valid and over the floor, in clusters of overlapping windows over
    a video of `video_s` seconds, with d - 3 extra columns."""
    rng = np.random.RandomState(seed)
    centre = rng.uniform(0, video_s, (rows, n // 16 + 1))
    pick = rng.randint(0, centre.shape[1], (rows, n))
    mid = np.take_along_axis(centre, pick, 1) + rng.normal(0, 3, (rows, n))
    half = rng.uniform(0.25, 12, (rows, n))
    cols = [mid - half, mid + half, rng.uniform(0.01, 1, (rows, n))]
    cols += [rng.uniform(0, 1, (rows, n)) for _ in range(d - 3)]
    return np.stack(cols, -1).astype(np.float32)


def spread(rows, n, d, seed):
    """(rows, n, d) candidates over the floor that overlap little, so that
    nearly every one is picked: the most picks a row can take."""
    rng = np.random.RandomState(seed)
    start = rng.uniform(0, 10.0 * n, (rows, n))
    cols = [start, start + rng.uniform(1, 20, (rows, n)),
            rng.uniform(0.01, 1, (rows, n))]
    cols += [rng.uniform(0, 1, (rows, n)) for _ in range(d - 3)]
    return np.stack(cols, -1).astype(np.float32)


def edge_rows(n=300, d=5):
    """(8, n, d) rows and their validity: none valid; one valid; equal
    scores on disjoint windows (the pick order is the index order); equal
    scores on one window (iou 1); two over the floor; the rest random,
    with some under the floor and some not valid."""
    rng = np.random.RandomState(11)
    seg = saturated(8, n, d, 12)
    valid = rng.rand(8, n) > 0.25
    valid[0] = False
    valid[1] = False
    valid[1, 17] = True
    valid[2:6] = True
    seg[2, :, 0] = np.arange(n) * 3.0
    seg[2, :, 1] = seg[2, :, 0] + 2.0
    seg[2, :, 2] = 0.5
    seg[3, :, :2] = (10.0, 14.0)
    seg[3, :, 2] = 0.75
    seg[4, :, 2] = 5e-4
    seg[4, [3, n - 1], 2] = (0.2, 0.9)
    seg[6, ::5, 2] = 5e-4
    return seg, valid


def cases():
    """name -> (segments, valid or None, score floor)."""
    row_1024 = saturated(1, 1024, 5, 3)[0]
    row_1024[1000:] = 0.0                   # zero padding past the valid rows
    edge, edge_valid = edge_rows()
    edge_odd, edge_odd_valid = edge_rows(n=1025, d=3)
    return {
        'cells (15, 2048, 5)': (saturated(15, 2048, 5, 0),
                                np.ones((15, 2048), bool), 1e-3),
        'cells (15, 2048, 5), every pick': (spread(15, 2048, 5, 13),
                                            np.ones((15, 2048), bool),
                                            1e-3),
        'padded row 64': (saturated(1, 64, 5, 1)[0], np.arange(64) < 40,
                          1e-3),
        'padded row 1000 of 1024': (row_1024, np.arange(1024) < 1000, 1e-3),
        'padded row 8192': (saturated(1, 8192, 5, 2, video_s=1600.0)[0],
                            np.ones(8192, bool), 1e-3),
        'padded row 9000 of 16384': (
            saturated(1, 16384, 5, 14, video_s=1800.0)[0],
            np.arange(16384) < 9000, 1e-3),
        'batch (60, 700, 4)': (saturated(60, 700, 4, 4),
                               np.random.RandomState(5).rand(60, 700) > 0.2,
                               1e-9),
        'edge rows, n 300': (edge, edge_valid, 1e-3),
        'edge rows, n 1025': (edge_odd, edge_odd_valid, 1e-3),
        'no valid mask, n 37': (saturated(3, 37, 6, 6), None, 1e-3),
    }


def need_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernel has no CPU mode')


def on_card(seg, valid):
    return (torch.from_numpy(seg).cuda(),
            None if valid is None else torch.from_numpy(valid).cuda())


def assert_same(got, got_count, want, want_count):
    assert torch.equal(got[..., -1], want[..., -1])       # kept flags
    assert torch.equal(got_count, want_count)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0.0)


def steps_counted():
    return [c.n for c in profiling.recorded().counts if c.name == 'nms.steps']


@pytest.mark.cuda
@pytest.mark.parametrize('top_k', [1, 37, 200, 10 ** 6])
@pytest.mark.parametrize('case', sorted(cases()))
def test_kernel_matches_plain_loop(case, top_k):
    """Through `soft_nms_device`: one launch, no synchronisation, the
    plain loop's blocks and picks, and `nms.steps` its longest row's."""
    need_card()
    seg, valid, thr = cases()[case]
    seg, valid = on_card(seg, valid)
    want, want_count = nms.soft_nms_plain(seg, 0.5, top_k, thr, valid)
    launches = soft_nms_cuda.LAUNCHES
    torch.cuda.synchronize()
    with profiling.recording():
        torch.cuda.set_sync_debug_mode('error')
        try:
            got, count = nms.soft_nms_device(seg, 0.5, top_k, thr, valid)
        finally:
            torch.cuda.set_sync_debug_mode('default')
    assert soft_nms_cuda.LAUNCHES == launches + 1
    assert_same(got, count, want, want_count)
    assert steps_counted() == [int(want_count.max())]


@pytest.mark.cuda
@pytest.mark.parametrize('sigma', [0.5, 0.3, 1.7])
@pytest.mark.parametrize('n', [1000, 2000, 3000, 5000, 8193, 12000])
def test_every_block_width_and_sigma(n, sigma):
    """Each width of the block (n up to 1024, 2048, 4096 and 8192: 1 to 8
    candidates a thread; past 8192 the row in the output) keeps the plain
    loop's rows, at sigmas whose reciprocal is and is not exact."""
    need_card()
    seg, valid = on_card(saturated(3, n, 5, 7, video_s=n / 5), None)
    want, want_count = nms.soft_nms_plain(seg, sigma, 5000, 1e-3, valid)
    got, count = soft_nms_cuda.soft_nms(seg, valid, sigma, 5000, 1e-3)
    assert_same(got, count, want, want_count)


@pytest.mark.cuda
def test_ties_pick_the_lowest_index_first():
    """Equal scores on disjoint windows decay nothing: the picks are the
    first top_k indices, and the last undone candidate is never picked."""
    need_card()
    seg, valid = edge_rows()
    seg, valid = on_card(seg[2:3], valid[2:3])
    for top_k, picked in ((37, 37), (10 ** 6, seg.shape[1] - 1)):
        got, count = nms.soft_nms_device(seg, 0.5, top_k, 1e-3, valid)
        kept = got[0, :, -1].cpu().numpy()
        assert int(count[0]) == picked
        assert kept[:picked].all() and not kept[picked:].any()


class _Stub(torch.nn.Module):
    head_classes = 16


@pytest.mark.cuda
def test_callers_take_the_kernel(monkeypatch):
    """THUMOS's `InferencePipeline.post_process_on_device` (one video,
    bf16 scores) and ANet's batched `infer.post.device_blocks` each
    launch the kernel once and keep the plain loop's rows."""
    need_card()
    dev = torch.device('cuda')
    rng = np.random.RandomState(9)

    def uniform(lo, hi, shape, dtype=torch.float32):
        return torch.from_numpy(rng.uniform(lo, hi, shape)).to(dev, dtype)

    w, p, k = 9, 126, _Stub.head_classes
    start = uniform(0, 200, (w, p, 1))
    dec = DecodedWindows(torch.cat([start, start + uniform(2, 40, (w, p, 1))],
                                   -1).clamp(0, 256),
                         uniform(0, 0.2, (w, p, k), torch.bfloat16),
                         uniform(0, 1, (w, p), torch.bfloat16),
                         uniform(0, 1, (w, p), torch.bfloat16))
    pipe = InferencePipeline(_Stub(), use_edl=True, os_head=True, top_k=200,
                             device=dev)
    offsets = [128 * i for i in range(w)]
    b, p_anet, k_anet = 2, 630, 21
    start = uniform(0, 700, (b, p_anet, 1))
    anet = (torch.cat([start, start + uniform(5, 200, (b, p_anet, 1))], -1)
            / torch.full((b,), 5.0, device=dev)[:, None, None],
            uniform(0, 0.2, (b, p_anet, k_anet)),
            uniform(0, 1, (b, p_anet)), uniform(0, 1, (b, p_anet)),
            list(range(1, k_anet)), 0.001, True, 512, 0.5, 100)

    launches = soft_nms_cuda.LAUNCHES
    got = pipe.post_process_on_device(dec, offsets, 10.0)
    assert soft_nms_cuda.LAUNCHES == launches + 1
    blocks = post.device_blocks(*anet)
    assert soft_nms_cuda.LAUNCHES == launches + 2
    assert blocks.shape == (b, k_anet - 1, 512, 6)

    monkeypatch.setattr(post, 'soft_nms_device', nms.soft_nms_plain)
    want = pipe.post_process_on_device(dec, offsets, 10.0)
    assert len(got) > 100 and len(got) == len(want)
    for g, x in zip(got, want):
        assert (g['cls'], g['segment'], g['uncertainty'], g['actionness']) \
            == (x['cls'], x['segment'], x['uncertainty'], x['actionness'])
        np.testing.assert_allclose(g['score'], x['score'], rtol=1e-6)
    want_blocks = post.device_blocks(*anet)
    assert soft_nms_cuda.LAUNCHES == launches + 2
    assert torch.equal(blocks[..., -1], want_blocks[..., -1])
    torch.testing.assert_close(blocks, want_blocks, rtol=1e-6, atol=0.0)


@pytest.mark.cuda
def test_card_blocks_never_take_the_plain_loop(monkeypatch):
    """On the card every block goes to the kernel: half-precision blocks
    widened to float32 (exactly), float64 refused, never the plain
    loop."""
    need_card()
    monkeypatch.setattr(nms, 'soft_nms_plain', None)
    seg, _ = on_card(saturated(4, 300, 5, 16), None)
    want, want_count = soft_nms_cuda.soft_nms(
        seg.bfloat16().float(), None, 0.5, 200, 1e-3)
    launches = soft_nms_cuda.LAUNCHES
    got, count = nms.soft_nms_device(seg.bfloat16(), 0.5, 200, 1e-3)
    assert soft_nms_cuda.LAUNCHES == launches + 1
    assert got.dtype == torch.float32
    assert torch.equal(got, want) and torch.equal(count, want_count)
    with pytest.raises(TypeError, match='float32'):
        nms.soft_nms_device(seg.double(), 0.5, 200, 1e-3)
    assert soft_nms_cuda.LAUNCHES == launches + 1
