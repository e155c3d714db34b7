"""Packed device ingest with RGB + flow fusion on the card against the
CPU, at a small size (frame 128, crop 32), in float32 with TF32 off.
This file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_packed_cuda.py

Without a card its tests skip.
"""

import numpy as np
import pytest
import torch

from proposal_matching import assert_proposal_parity

from opental_torch import factory
from opental_torch.infer.pipeline import InferencePipeline
from opental_torch.models.bdnet import BDNet
from opental_torch.ops import boundary_pool_cuda

CLIP, CROP = 128, 32


def videos(seed=0):
    """Five videos (one shorter than a clip, one whose npy is shorter
    than its sample count, one longer than the frame capacity) and their
    flow frames, one frame shorter."""
    rng = np.random.RandomState(seed)
    spec = [('a', 100, 100), ('b', 200, 200), ('c', 180, 180),
            ('d', 300, 420), ('e', 700, 700)]
    return [(n, rng.randint(0, 256, (t, 40, 40, 3), dtype=np.uint8), c,
             10.0, rng.randint(0, 256, (t - 1, 40, 40, 2), dtype=np.uint8))
            for n, t, c in spec]


def as_json(results):
    return {'results': {name: [dict(p, label=str(p['cls'])) for p in props]
                        for name, props in results.items()}}


@pytest.mark.cuda
def test_packed_fused_ingest_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the pool kernel has no CPU mode')
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = {}
        for device in ('cpu', 'cuda'):
            rgb = factory.init_weights(BDNet(
                num_classes=5, os_head=True, use_edl=True, frame_num=CLIP,
                crop_size=CROP), seed=0)
            flow = factory.init_weights(BDNet(
                in_channels=2, num_classes=5, os_head=True, use_edl=True,
                frame_num=CLIP, crop_size=CROP), seed=1)
            pipe = InferencePipeline(rgb, flow_model=flow, clip_length=CLIP,
                                     stride=64, crop_size=CROP, top_k=50,
                                     use_edl=True, os_head=True,
                                     device=device)
            before = boundary_pool_cuda.LAUNCHES
            out[device] = pipe.run_videos(iter(videos()), max_batch=4,
                                          frames_capacity=512)
            launched = boundary_pool_cuda.LAUNCHES - before
        torch.cuda.synchronize()
        assert launched > 0 and launched % 4 == 0, launched
        assert_proposal_parity(as_json(out['cpu']), as_json(out['cuda']),
                               min_total=50)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


@pytest.mark.cuda
def test_device_windows_equal_host_windows_on_card():
    """Windows gathered and normalized on the card equal the host-staged
    float32 windows bit for bit (every uint8 value occurs), with a scalar
    and a per-window frames-valid, and the gather never synchronizes the
    host (sync debug mode 'error')."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    from opental_torch.infer.pipeline import (device_windows, stack_windows,
                                              stage_frames)
    rng = np.random.RandomState(1)
    data = rng.randint(0, 256, (150, 6, 5, 3), np.uint8)
    offsets = [0, 40, 80, 120]
    buf = stage_frames(data, pad_to=184, device='cuda')
    offs = torch.tensor(offsets, device='cuda')
    valid = torch.full((len(offsets),), 150, device='cuda')
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        got = [device_windows(buf, offs, fv, 64) for fv in (150, valid)]
    finally:
        torch.cuda.set_sync_debug_mode('default')
    want = torch.from_numpy(stack_windows(data, offsets, 64))
    for g in got:
        assert torch.equal(g.cpu(), want.permute(0, 4, 1, 2, 3))
