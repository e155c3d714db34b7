"""The open-set slice on the card, at a small size (frame 128, crop 32):
shared-backbone span gathers, the RPL / GCPL train step and the
`get_feat` taps, each through the CUDA pool kernels against the plain
path. This file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_openset_cuda.py

Without a card its tests skip.
"""

import contextlib

import numpy as np
import pytest
import torch

from opental_torch import factory
from opental_torch.infer.pipeline import (device_windows, snapped_offsets,
                                          span_plan, stage_frames,
                                          window_features)
from opental_torch.losses.multisegment import LossConfig
from opental_torch.models.bdnet import BDNet
from opental_torch.ops import boundary_pool, boundary_pool_cuda
from opental_torch.train.step import LossWeights, compute_losses, \
    device_ingest

CLIP, CROP, STRIDE = 128, 32, 64
SPAN = STRIDE * 3 + CLIP + 8


def need_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the pool kernels have no CPU mode')


@contextlib.contextmanager
def tf32_off():
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


@pytest.mark.cuda
def test_span_gather_equals_host_spans_without_sync():
    """Two videos packed in one buffer: their spans gathered and
    normalized on the card equal spans cut on the host (each zero past
    its video's frames-valid) bit for bit, and neither the gather nor the
    per-window feature slicing synchronizes the host."""
    need_card()
    rng = np.random.RandomState(0)
    a = rng.randint(0, 256, (341, 6, 5, 3), np.uint8)
    b = rng.randint(0, 256, (200, 6, 5, 3), np.uint8)
    bases_a, local_a, _ = span_plan(snapped_offsets(400, CLIP, STRIDE), 4)
    bases_b, local_b, _ = span_plan(snapped_offsets(200, CLIP, STRIDE), 4)
    start_b = -(-(int(bases_a[-1]) + SPAN) // 8) * 8
    total = start_b + max(int(bases_b[-1]) + SPAN, len(b))
    host = np.zeros((total, 6, 5, 3), np.uint8)
    host[:len(a)] = a
    host[start_b:start_b + len(b)] = b
    bases = np.concatenate([bases_a, start_b + bases_b])
    valid = np.array([min(len(a), 400)] * len(bases_a)
                     + [start_b + len(b)] * len(bases_b))
    buf = stage_frames(host, device='cuda')
    bases_d = torch.from_numpy(bases).cuda()
    valid_d = torch.from_numpy(valid).cuda()
    local_d = torch.from_numpy(np.concatenate([local_a, local_b])).cuda()
    feats = {'Mixed_4f': torch.randn(len(bases), 7, SPAN // 4, 2, 2,
                                     device='cuda'),
             'Mixed_5c': torch.randn(len(bases), 9, SPAN // 8, 1, 1,
                                     device='cuda')}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        got = device_windows(buf, bases_d, valid_d, SPAN)
        sliced = window_features(feats, local_d, CLIP)
    finally:
        torch.cuda.set_sync_debug_mode('default')
    want = np.zeros((len(bases), SPAN, 6, 5, 3), np.float32)
    for i, (base, fv) in enumerate(zip(bases, valid)):
        clip = host[base:base + SPAN].astype(np.float32)
        clip = (clip / 255.0) * 2.0 - 1.0
        clip[max(0, fv - base):] = 0.0
        want[i] = clip
    assert torch.equal(got.cpu(), torch.from_numpy(want).permute(
        0, 4, 1, 2, 3))
    local = np.concatenate([local_a, local_b])
    for key, s in (('Mixed_4f', 4), ('Mixed_5c', 8)):
        f = feats[key].cpu()
        for g in range(len(bases)):
            for j in range(4):
                lo = int(local[g, j]) // s
                assert torch.equal(sliced[key][4 * g + j].cpu(),
                                   f[g, :, lo:lo + CLIP // s])


def rpl_batch(b, seed):
    rng = np.random.RandomState(seed)
    truths = np.zeros((b, 4, 2), np.float32)
    labels = np.zeros((b, 4), np.int64)
    gt_mask = np.zeros((b, 4), bool)
    for i in range(b):
        k = rng.randint(1, 4)
        s = rng.uniform(0, 0.7, k)
        truths[i, :k] = np.stack([s, np.clip(s + rng.uniform(0.05, 0.3, k),
                                             0, 1)], -1)
        labels[i, :k] = rng.randint(1, 16, k)
        gt_mask[i, :k] = True
    batch = {'truths': truths, 'labels': labels, 'gt_mask': gt_mask,
             'scores': (rng.rand(b, 2, CLIP) > 0.9).astype(np.float32),
             'ssl_props': np.tile(np.array([[[10., 40.], [60., 100.],
                                             [45., 55.]]], np.float32),
                                  (b, 1, 1)),
             'ssl_flags': np.ones((b,), np.float32),
             'clips': rng.randint(0, 256, (b, CLIP, CROP, CROP, 3),
                                  dtype=np.uint8),
             'ssl_clips': rng.randint(0, 256, (b, CLIP, CROP, CROP, 3),
                                      dtype=np.uint8)}
    return {k: torch.from_numpy(v).cuda() for k, v in batch.items()}


@pytest.mark.cuda
@pytest.mark.parametrize('gcpl', [False, True])
def test_rpl_step_kernel_path_equals_plain(gcpl):
    """One RPL / GCPL step (loss and backward): 4 B1 and 4 B2 launches;
    the loss terms equal the plain path's bit for bit and every gradient
    (the centers' and the radius' too) within rtol 1e-5."""
    need_card()
    with tf32_off():
        model = factory.init_train_weights(BDNet(
            num_classes=16, use_rpl=True, frame_num=CLIP, crop_size=CROP),
            seed=0).cuda().train()
        cfg = LossConfig(num_classes=16, clip_length=CLIP, piou=0.5,
                         cls_type='rpl', rpl_gcpl=gcpl)
        batch = device_ingest(rpl_batch(1, 3))

        def step():
            model.zero_grad(set_to_none=True)
            cost, terms, _ = compute_losses(model, cfg, LossWeights(), batch,
                                            None, 1)
            cost.backward()
            return terms, {n: p.grad.clone() for n, p in
                           model.named_parameters() if p.grad is not None}

        f0, b0 = boundary_pool_cuda.LAUNCHES, boundary_pool_cuda.BWD_LAUNCHES
        terms_k, grads_k = step()
        torch.cuda.synchronize()
        assert (boundary_pool_cuda.LAUNCHES - f0,
                boundary_pool_cuda.BWD_LAUNCHES - b0) == (4, 4)
        with boundary_pool.force_plain():
            terms_p, grads_p = step()
    for k in terms_k:
        assert torch.equal(terms_k[k], terms_p[k]), k
    assert set(grads_k) == set(grads_p)
    assert 'coarse_pyramid_detection.conf_head.centers' in grads_k
    assert ('coarse_pyramid_detection.rpl_radius' in grads_k) is not gcpl
    for n, gk in grads_k.items():
        scale = grads_p[n].abs().max().item()
        torch.testing.assert_close(gk, grads_p[n], rtol=1e-5,
                                   atol=1e-5 * scale)


@pytest.mark.cuda
def test_get_feat_kernel_path_equals_plain():
    """The closed-set model's `get_feat` taps and logits through B1 (2
    launches) equal the plain path's bit for bit."""
    need_card()
    model = factory.init_weights(BDNet(num_classes=16, frame_num=CLIP,
                                       crop_size=CROP), seed=1).cuda().eval()
    x = device_ingest(rpl_batch(3, 4))['clips']
    with tf32_off(), torch.inference_mode():
        before = boundary_pool_cuda.LAUNCHES
        out_k = model(x, get_feat=True)
        torch.cuda.synchronize()
        assert boundary_pool_cuda.LAUNCHES - before == 2
        with boundary_pool.force_plain():
            out_p = model(x, get_feat=True)
    for k in ('conf_feat', 'prop_conf_feat', 'conf', 'prop_conf', 'loc'):
        assert torch.equal(out_k[k], out_p[k]), k
    assert out_k['conf_feat'].shape == (3, 63, 512)
