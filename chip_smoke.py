#!/usr/bin/env python3
"""Drive the PyTorch port (opental_torch) on one NVIDIA card.

    python3 chip_smoke.py            # from the root of a checkout

Phases (any failure ends the run with a non-zero exit):
  1. card, versions; build the CUDA kernels from csrc/ (nvcc, in parallel)
     and libmr from native/libmr/libmr.cpp (g++)
  2. B1, the grouped pool forward, vs its plain PyTorch version on the
     card, at the inputs inference gives it (the 2 calls of a full-width
     forward at W=32) and on per-level adversarial segments, in float32
     and bfloat16; its time per forward in turns with the per-level
     route (the same kernel through its one-level entry, 24 calls), the
     plain version, the group bound and the summed per-call bound
  3. B2, the grouped pool backward, vs its plain version, on the (x,
     segments, g) of the 4 backward calls of one full-width train step
     and on tied inputs, in float32 and bfloat16; its time per step in
     turns with the per-level route (27 calls), the plain version,
     scatter_add_ and the bound
  4. one full-width bs=1 train step of the OpenTAL-final model in
     float32, TF32 off: the kernel path vs the plain path (4 forward and
     4 backward launches), and the card vs the CPU
  5. the full-width BDNet (256 x 96 x 96, seeded weights) in float32 with
     TF32 off: card vs CPU at W=1, kernel path vs plain path at W=32, 2
     kernel launches per forward
  6. inference end to end: synthetic uint8 videos through
     opental_torch.tools.test.run_test at the default bf16 (packed device
     ingest), to a detection JSON; launch counts are read from this run
     only
  7. training end to end: opental_torch.train.loop.train and the
     tools.train CLI at full width on synthetic videos (2 epochs, a
     checkpoint, a resume), then run_test on the result; launch counts
     are read from this run only
  8. train step time at bs=1 and bs=8 (f32), peak memory, a profile
  9. forward + decode windows/s at W=32 and W=128 (bf16), with
     model.stem_pallas off and on in turns, soft-NMS time per video
 10. the stem pack kernel (csrc/stem_pack.cu: B3, the v1 layout, and B4,
     the v2 layout) and the strided-copy yardstick vs the plain version,
     exactly, through every plan of the kernel, on the padded W=32 batch
     as the model hands it over, its contiguous copy and odd shapes
     (`pack_cases`), f32 and bf16, fp 1 and 2; times of kernel, plain
     version, yardstick and bound at the main paths' inputs (B4 at W=32
     and W=128, B3 at bs=1 and bs=8), and of the tile plan beside B4
 11. the stem convolution at W=32: cuDNN's plain stride-2 Conv3d vs pack +
     F.conv2d in each layout (bf16; f32 with and without TF32), and the
     forward + weight gradient at bs=1 and bs=8
 12. the full-width BDNet with model.stem_pallas on, f32, TF32 off: card
     vs CPU at W=1, flag on vs off at W=32, 1 pack per forward
 13. inference end to end with model.stem_pallas on (run_test); launch
     counts are read from this run only
 14. one full-width bs=1 train step with model.stem_pallas on vs off
     (f32, TF32 off): losses, grad norm, the stem's gradient
 15. training end to end with model.stem_pallas on (train.loop.train);
     launch counts are read from this run only
 16. packed device ingest at full width: run_test with the shipped
     defaults (bf16, 128 windows per forward, 16384 frames per flush)
     over 9 synthetic videos (one shorter than a clip, one of 33000
     frames: 2 flushes, 2 full forwards and padded tails), B1 launches
     against the scheduler's forwards, windows/s of the first and warm
     runs, the device's busy share, peak memory; the same videos one at
     a time (testing.packed: false) in turns with the packed runs; one
     more packed run with its window gathers and forwards timed by CUDA
     events and its post-processing on the host clock
 17. f32, TF32 off, on 4 of those videos: packed vs per-video, and the
     host-staged modes (testing.device_ingest: false, packed and per
     video) vs device ingest, per proposal at rtol 1e-4
 18. the kernels at the fused packed forward's shapes: B1 on both
     streams' pool inputs at W=128, B4 at C = 2 (the flow stream's stem)
     against their plain versions exactly; B4 at C = 2 timed
 19. RGB + flow fusion (seeded 2-channel flow weights, flow npys a frame
     shorter) packed end to end with model.stem_pallas off and on: launch
     counts, windows/s, peak memory
 20. threshold calibration: the tools.threshold CLI with --fusion over
     the same videos as the training set
 21. ActivityNet (configs/anet_opental.yaml: 151 classes, 768 x 96 x
     96): B1 and B2 vs their plain versions exactly on the pool inputs of
     a W=4 bf16 forward and a bs=2 f32 train step, on adversarial windows
     and on bounds of +-1e10, +-inf and NaN; their times against the
     group bound, the plain version and scatter_add_
 22. the ANet BDNet in f32, TF32 off: card vs CPU at W=1, kernel path vs
     plain path at W=4 bit for bit, 2 B1 launches per forward
 23. one ANet bs=2 f32 train step, TF32 off: kernel path vs plain path
     (losses, gradients), 4 B1 + 4 B2 launches, the dual-LR Adam (the
     backbone at 0.1 x the heads' rate); the step's time, peak memory
     and busy share
 24. ANet inference end to end: tools.test_anet.run_test_anet (bf16,
     video_batch 4) over 10 synthetic videos (padded and cut; 3
     forwards, a padded tail), first and warm runs, forward + decode and
     post-processing per batch, busy share, device_nms true vs false in
     f32, fused RGB + flow, the CLI's --binary with a classifier file,
     calibrate_anet through the tools.threshold CLI; launch counts read
     from each run only
 25. ANet training end to end: tools.train for 2 epochs, a checkpoint, a
     resume, then run_test_anet on the result
 26. shared-backbone inference (testing.shared_backbone: 4-window spans
     of 648 frames, up to 48 per forward): run_test packed and per video
     over the packed videos, B1 launches against the span scheduler's
     forwards, windows/s of the first run and warm runs in turns with the
     default packed path (bf16), busy share, peak memory; B1 exactly
     against its plain version on a shared forward's pool inputs and B4
     at the span shape, each timed against its bound; in f32 the
     interior windows' sliced features against a per-window backbone,
     card == CPU on one short video; model.stem_pallas on the spans
 27. RPL and GCPL (configs/thumos14_open_{rpl,gcpl}.yaml): a bs=1 f32
     step, TF32 off, kernel path vs plain path (4 + 4 launches) and card
     vs CPU; the step time against the OpenTAL step, in turns; tools.train
     for 2 steps with a checkpoint, then run_test (GCPL negated)
 28. OpenMax (configs/thumos14_openmax.yaml) on synthetic videos of its 15
     classes: stage 1 (MAVs of the get_feat taps, kernel path == plain
     path), stage 2 (Weibull fit, libmr built with g++), stage 3
     (recalibrated test), the tools.test_openmax CLI, tools.eval_open;
     the time of each stage
 29. tools.test_cross_data over the phase-6 videos and synthetic
     ActivityNet videos, and tools.search_param over a 2 x 2 grid, its
     cache re-read
Phases 8 and 9 run with model.stem_pallas off and on. Then a `kernels`
JSON line, the card's name and power limit, and as the last line
{"ok": true, "device": {...}}. Weights and data are random, made from
seeds; no network, one card.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F
import yaml

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from opental_torch import factory  # noqa: E402
from opental_torch.config import load_config  # noqa: E402
from opental_torch.data.thumos import get_class_index_map  # noqa: E402
from opental_torch.infer import pipeline as pipeline_mod  # noqa: E402
from opental_torch.infer.pipeline import (InferencePipeline,  # noqa: E402
                                          window_offsets)
from opental_torch.losses.edl import EDLState  # noqa: E402
from opental_torch.models import bdnet as bdnet_mod  # noqa: E402
from opental_torch.models import pyramid  # noqa: E402
from opental_torch.models import layers  # noqa: E402
from opental_torch.models.bdnet import BDNet  # noqa: E402
from opental_torch.ops import (_build, boundary_pool,  # noqa: E402
                               boundary_pool_cuda, stem_pack, stem_pack_cuda)
from opental_torch.openset import libmr  # noqa: E402
from opental_torch.openset.openmax import weibull_fitting  # noqa: E402
from opental_torch.tools import (eval_open, search_param,  # noqa: E402
                                 test_anet, test_cross_data, test_openmax)
from opental_torch.tools import threshold as threshold_cli  # noqa: E402
from opental_torch.tools import train as train_cli  # noqa: E402
from opental_torch.tools.test import build_pipeline, run_test  # noqa: E402
from opental_torch.train import checkpoint  # noqa: E402
from opental_torch.train.loop import SAVE_AFTER_EPOCH  # noqa: E402
from opental_torch.train.loop import (  # noqa: E402
    init_state as train_init_state)
from opental_torch.train.loop import train as train_loop  # noqa: E402
from opental_torch.train.step import (TrainState, compute_losses,  # noqa: E402
                                      device_ingest, global_norm,
                                      make_anet_optimizer, make_optimizer,
                                      train_step)
from opental_torch.utils.synthetic import (  # noqa: E402
    make_synthetic_anet_dataset, make_synthetic_dataset)

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
FRAMES, CROP, CLASSES = 256, 96, 16
CONFIG = 'configs/thumos14_opental_final.yaml'
OUT_KEYS = ('loc', 'conf', 'prop_loc', 'prop_conf', 'center', 'act',
            'prop_act', 'start', 'end', 'start_loc_prop', 'end_loc_prop',
            'start_conf_prop', 'end_conf_prop', 'unct', 'prop_unct')


T_START = time.perf_counter()


def log(*a):
    if a and str(a[0]).startswith('=='):     # phase lines: time into the run
        a = (f'[{time.perf_counter() - T_START:.0f} s]',) + a
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean time of fn() over `reps` back-to-back calls between CUDA
    events: host overhead between launches counts."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


_SLEEP_CYCLES_PER_MS = None


def device_ms(fn, reps: int = 20) -> float:
    """Mean device time of fn() over `reps` calls: a sleep kernel holds
    the stream while the host queues every call, so the events see the
    calls run back to back, without the host's launch overhead between
    them. Inputs stay where the caller left them (usually in L2, as the
    producer of a pool input on the main path leaves it)."""
    global _SLEEP_CYCLES_PER_MS
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if _SLEEP_CYCLES_PER_MS is None:
        torch.cuda._sleep(1_000_000)
        start.record()
        torch.cuda._sleep(20_000_000)
        end.record()
        torch.cuda.synchronize()
        _SLEEP_CYCLES_PER_MS = 20_000_000 / start.elapsed_time(end)
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    call_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda._sleep(int((3 * reps * call_ms + 1) * _SLEEP_CYCLES_PER_MS))
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    queued_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    if queued_ms > 3 * reps * call_ms + 1:
        raise RuntimeError('the host did not queue the calls within the '
                           'sleep: the device time would include gaps')
    return start.elapsed_time(end) / reps


def pool_bound_ms(x: torch.Tensor, seg: torch.Tensor, levels=None,
                  argmax: bool = False) -> float:
    """Least time for one pool call: every x row that a window of its
    level covers, read once, the segments and the output (and the int32
    argmax), over the memory rate. Summed over the per-level calls of the
    per-level route it is the per-call bound; for a grouped call it is the
    group bound."""
    b, t_len, c = x.shape
    levels = boundary_pool_cuda.check_levels(levels, t_len, seg.shape[1])
    rows, x_off, k_off = 0, 0, 0
    for t, k in levels:
        if k:
            l, r = boundary_pool.clamp_windows(seg[:, k_off:k_off + k], t)
            pos = torch.arange(t, device=x.device)
            cover = ((pos >= l[..., None]) & (pos <= r[..., None])).any(
                dim=1)                                      # (b, half, t)
            rows += int(cover.sum())
        x_off, k_off = x_off + t, k_off + k
    out_bytes = x.element_size() + (4 if argmax else 0)
    nbytes = (rows * (c // 2) * x.element_size() + seg.numel() * 4
              + b * seg.shape[1] * c * out_bytes)
    return nbytes / HBM_BYTES_PER_S * 1e3


POOLS_PER_FORWARD = 2     # the frame-level pool, the packed lr pool
ROI_LEVELS = ((FRAMES, sum(pyramid.level_sizes(FRAMES))),)


def per_level_route(x, seg, levels, g=None):
    """The per-level calls that the model made before its pools were
    grouped, for one grouped call, as
    (x, segments, g): the frame-level pool of all 6 levels as 6 calls for
    each of the 2 branches (the same g slice for both), a packed call as
    one call per level, any other call as itself."""
    if levels == ROI_LEVELS:
        pieces, k0 = [], 0
        for t in pyramid.level_sizes(FRAMES):
            pieces.append((0, FRAMES, k0, t))
            k0 += t
        pieces = pieces * 2
    else:
        pieces, x0, k0 = [], 0, 0
        for t, k in levels:
            pieces.append((x0, t, k0, k))
            x0, k0 = x0 + t, k0 + k
    return [(x[:, x0:x0 + t].contiguous(), seg[:, k0:k0 + k].contiguous(),
             None if g is None else g[:, k0:k0 + k].contiguous())
            for x0, t, k0, k in pieces]


def random_clips(n: int, seed: int, frames: int = FRAMES) -> torch.Tensor:
    """(n, 3, frames, CROP, CROP) float32 clips in [-1, 1], made on the
    card from a seed."""
    g = torch.Generator(device='cuda').manual_seed(seed)
    u8 = torch.randint(0, 256, (n, 3, frames, CROP, CROP), generator=g,
                       device='cuda', dtype=torch.uint8)
    return (u8.float() / 255.0) * 2.0 - 1.0


def build_model(state_dict, dtype, device, stem_pallas=False) -> BDNet:
    m = BDNet(num_classes=CLASSES, os_head=True, use_edl=True,
              evidence='exp', frame_num=FRAMES, crop_size=CROP,
              stem_pallas=stem_pallas,
              dtype=None if dtype == torch.float32 else dtype)
    m.load_state_dict(state_dict, strict=True)
    return m.to(device).eval()


def capture_pool_inputs(model: BDNet, clips: torch.Tensor):
    """(x, segments, levels) of every boundary-pool call of one forward."""
    calls = []
    real = pyramid.boundary_max_pool_segmented

    def recording(x, seg, levels):
        calls.append((x.clone(), seg.clone(), levels))
        return real(x, seg, levels)

    pyramid.boundary_max_pool_segmented = recording
    try:
        with torch.inference_mode():
            model(clips)
    finally:
        pyramid.boundary_max_pool_segmented = real
    return calls


def adversarial_segments(b: int, k: int, t_len: int, seed: int
                         ) -> torch.Tensor:
    rng = np.random.RandomState(seed)
    l = rng.randint(-t_len // 2, t_len + t_len // 2, (b, k, 2))
    r = l + rng.randint(-6, t_len // 2 + 2, (b, k, 2))
    seg = np.stack([l[..., 0], r[..., 0], l[..., 1], r[..., 1]], -1)
    seg = seg + rng.uniform(-0.99, 0.99, seg.shape)
    seg[:, ::5] = [-3.5, t_len + 9.5, -0.5, t_len - 0.5]     # full range
    seg[:, 1::5] = [5.2, 2.7, t_len + 4.0, t_len + 1.0]      # r < l
    return torch.from_numpy(seg.astype(np.float32)).cuda()


def adversarial_levels(b: int, levels, seed: int) -> torch.Tensor:
    """Adversarial segments for every level of a table, each in its own
    level's units: windows that reach past the level on either side (into
    its neighbours on the packed axis), wholly outside it, r < l."""
    return torch.cat([adversarial_segments(b, k, t, seed + i)
                      for i, (t, k) in enumerate(levels)], dim=1)


def in_turns(fns: dict, reps: int, measure) -> dict:
    """measure(fn, reps) of each fn in the order a, b, b, a (the two
    drift alike with the card), averaged."""
    out = {name: 0.0 for name in fns}
    for name in list(fns) + list(fns)[::-1]:
        out[name] += measure(fns[name], reps) / 2
    return out


@contextlib.contextmanager
def tf32_off():
    """TF32 off and cuDNN deterministic, restored after."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = saved
        torch.cuda.empty_cache()


def phase_kernel_vs_plain(calls):
    log('== phase 2: grouped boundary_max_pool_fwd (B1) vs plain version '
        'on the card')
    max_err = 0.0
    for i, (x, seg, levels) in enumerate(calls):
        for dtype in (torch.float32, torch.bfloat16):
            xd = x.to(dtype).contiguous()
            for segs in (seg, adversarial_levels(x.shape[0], levels,
                                                 10 * i)):
                got, _ = boundary_pool_cuda.boundary_max_pool_fwd(
                    xd, segs, levels=levels)
                with boundary_pool.force_plain():
                    want = boundary_pool.boundary_max_pool_segmented(
                        xd, segs, levels)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                max_err = max(max_err, err)
                if not torch.equal(got, want):
                    raise AssertionError(f'kernel != plain: call {i} '
                                         f'{tuple(x.shape)} {dtype} err {err}')
    log(f'grouped kernel == plain exactly on the {len(calls)} main-path '
        f'calls x (f32, bf16) x (captured, per-level adversarial) segments; '
        f'max_abs_err {max_err}')

    # time: the 2 grouped calls of one forward against the per-level
    # route, the same kernel through its one-level entry, 24 calls
    route = [c for x, seg, levels in calls
             for c in per_level_route(x, seg, levels)]
    assert len(route) == 24, len(route)

    def run(cs):
        return lambda: [boundary_pool_cuda.boundary_max_pool_fwd(
            x, seg, levels=levels) for x, seg, levels in cs]

    grouped = run(calls)
    per_level = run([(x, seg, None) for x, seg, _ in route])
    dev = in_turns({'route': per_level, 'grouped': grouped}, 20, device_ms)
    host = in_turns({'route': per_level, 'grouped': grouped}, 20, time_ms)

    def plain():
        with boundary_pool.force_plain():
            for x, seg, levels in calls:
                boundary_pool.boundary_max_pool_segmented(x, seg, levels)

    tot = {'ms': dev['grouped'], 'call_ms': host['grouped'],
           'route_ms': dev['route'], 'route_call_ms': host['route'],
           'plain_ms': device_ms(plain, reps=3),
           'bound_ms': sum(pool_bound_ms(*c) for c in calls),
           'call_bound_ms': sum(pool_bound_ms(x, seg)
                                for x, seg, _ in route)}
    for i, (x, seg, levels) in enumerate(calls):
        log(f'call {i}: x {tuple(x.shape)} {x.dtype}, K {seg.shape[1]}, '
            f'{len(levels)} levels; group bound '
            f'{pool_bound_ms(x, seg, levels):.6f} ms')
    log(f'one forward (W=32, inputs as the bf16 model gives them), device '
        f'ms: grouped, {len(calls)} calls: {tot["ms"]} ({tot["call_ms"]} '
        f'with host overhead); per-level route, 24 calls: {tot["route_ms"]} '
        f'({tot["route_call_ms"]}); plain {tot["plain_ms"]}; group bound '
        f'{tot["bound_ms"]}, summed per-call bound {tot["call_bound_ms"]}; '
        f'grouped at {tot["bound_ms"] / tot["ms"]:.3f} of the group bound '
        f'and {tot["call_bound_ms"] / tot["ms"]:.3f} of the per-call bound, '
        f'the route at {tot["call_bound_ms"] / tot["route_ms"]:.3f} of the '
        f'per-call bound; {card_line()}')
    return max_err, tot


def phase_full_width(state_dict):
    log('== phase 5: full-width BDNet f32, TF32 off')
    # the later phases measure the main path with PyTorch's defaults
    with tf32_off():
        compare_full_width(state_dict)


def compare_full_width(state_dict):
    model = build_model(state_dict, torch.float32, 'cuda')
    clips = random_clips(32, seed=1)
    with torch.inference_mode():
        dev1 = model(clips[:1])
    torch.cuda.synchronize()
    cpu_model = build_model(state_dict, torch.float32, 'cpu')
    t0 = time.perf_counter()
    with torch.inference_mode():
        ref1 = cpu_model(clips[:1].cpu())
    log(f'CPU reference forward W=1: {time.perf_counter() - t0:.1f} s')
    for key in OUT_KEYS:
        got, want = dev1[key].float().cpu(), ref1[key].float()
        assert got.shape == want.shape, (key, got.shape, want.shape)
        assert torch.isfinite(got).all(), key
        torch.testing.assert_close(got, want, rtol=1e-3, atol=2e-3,
                                   msg=lambda m: f'{key}: {m}')
    log('card == CPU at W=1 (rtol 1e-3, atol 2e-3) on every out key')

    # kernel path vs plain path at W=32: the pool is exact either way, so
    # with deterministic cuDNN the whole forward must be bit-equal
    before = boundary_pool_cuda.LAUNCHES
    with torch.inference_mode():
        out_k = model(clips)
    launched = boundary_pool_cuda.LAUNCHES - before
    with torch.inference_mode(), boundary_pool.force_plain():
        out_p = model(clips)
    torch.cuda.synchronize()
    assert launched == POOLS_PER_FORWARD, \
        f'{launched} kernel launches in one forward'
    for key in OUT_KEYS:
        if not torch.equal(out_k[key], out_p[key]):
            diff = (out_k[key] - out_p[key]).abs().max().item()
            raise AssertionError(f'kernel path != plain path on {key}: '
                                 f'{diff}')
    log(f'W=32: kernel path == plain path bit for bit on every out key; '
        f'{launched} launches per forward')
    del model, cpu_model, out_k, out_p, clips
    torch.cuda.empty_cache()


def write_dataset(root: str, seed: int = 0):
    """4 synthetic uint8 videos at 112 x 112 (center-cropped to 96 by the
    pipeline), their video-info CSV and a 15-class index file."""
    rng = np.random.RandomState(seed)
    npy = os.path.join(root, 'test_npy')
    os.makedirs(npy)
    rows = ['video,fps,sample_fps,count,sample_count']
    lengths = {}
    for v, t in enumerate((600, 1100, 1500, 2000)):
        name = f'video_test_{v:07d}'
        video = rng.randint(0, 256, (t, 112, 112, 3), dtype=np.uint8)
        ramp = np.linspace(-40, 40, t).astype(np.int16)[:, None, None, None]
        for _ in range(3):       # brighter action-like segments
            s = rng.randint(0, t - 100)
            ramp[s:s + rng.randint(30, 100)] += 50
        video = np.clip(video.astype(np.int16) + ramp, 0, 255).astype(
            np.uint8)
        np.save(os.path.join(npy, name + '.npy'), video)
        rows.append(f'{name},30.0,10.0,{t * 3},{t}')
        lengths[name] = t
    with open(os.path.join(root, 'video_info.csv'), 'w') as f:
        f.write('\n'.join(rows) + '\n')
    with open(os.path.join(root, 'classes.txt'), 'w') as f:
        f.write(''.join(f'{i} Class{i:02d}\n' for i in range(1, 16)))
    return lengths


def check_detection_json(path, lengths) -> int:
    """The detection JSON has every video, finite proposals with ordered
    segments, and some proposals; returns their number."""
    with open(path) as f:
        payload = json.load(f)
    assert set(payload) >= {'version', 'results'}, set(payload)
    assert set(payload['results']) == set(lengths)
    n_props = 0
    for props in payload['results'].values():
        for p in props:
            assert set(p) == {'label', 'score', 'segment', 'uncertainty',
                              'actionness'}, set(p)
            vals = [p['score'], p['uncertainty'], p['actionness'],
                    *p['segment']]
            assert all(math.isfinite(v) for v in vals), p
            assert 0.0 <= p['segment'][0] <= p['segment'][1]
        n_props += len(props)
    assert n_props > 0, 'no proposals'
    return n_props


def synthetic_test_config(root, **overrides):
    """The shipped config on the synthetic videos of phase 6."""
    return load_config(CONFIG, overrides=dict({
        'dataset.class_info_path': os.path.join(root, 'classes.txt'),
        'dataset.testing.video_info_path': os.path.join(root,
                                                        'video_info.csv'),
        'dataset.testing.video_data_path': os.path.join(root, 'test_npy'),
        'testing.checkpoint_path': os.path.join(root, 'checkpoint-1.ckpt'),
        'testing.output_path': os.path.join(root, 'out'),
    }, **overrides))


PACKED_BATCH, PACKED_FRAMES = 128, 16384   # the shipped packing defaults


def ingest_plan(videos, capacity: int = PACKED_FRAMES,
                batch: int = PACKED_BATCH):
    """(forwards, full forwards, flushes, windows) of run_videos_ingest
    over videos [(frames, sample_count, flow frames or 0)], by the
    scheduler's rule restated: a video opens a new flush where its region
    (its last window's end or its frame count, whichever is larger) would
    overflow the capacity; each flush pads its windows to whole
    forwards."""
    flush_windows, cursor = [0], 0
    for t, count, tf in videos:
        offs = window_offsets(count, FRAMES, 128)
        region = max(offs[-1] + FRAMES, t, tf)
        if cursor and cursor + region > capacity:
            flush_windows.append(0)
            cursor = 0
        cursor += region
        flush_windows[-1] += len(offs)
    return (sum(-(-w // batch) for w in flush_windows),
            sum(w // batch for w in flush_windows), len(flush_windows),
            sum(flush_windows))


def forwards_of(lengths) -> int:
    """Forwards of run_test in its default mode (packed device ingest)."""
    return ingest_plan([(t, t, 0) for t in lengths.values()])[0]


def phase_end_to_end(state_dict, root):
    log('== phase 6: inference end to end (tools.test.run_test, bf16)')
    lengths = write_dataset(root)
    torch.save(state_dict, os.path.join(root, 'checkpoint-1.ckpt'))
    cfg = synthetic_test_config(root)
    n_windows = sum(len(window_offsets(t, FRAMES, 128))
                    for t in lengths.values())
    n_forwards = forwards_of(lengths)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = run_test(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = boundary_pool_cuda.LAUNCHES
    assert boundary_pool_cuda.BWD_LAUNCHES == 0, 'backward in inference'
    assert pack_launches() == 0, 'stem pack with model.stem_pallas off'
    n_props = check_detection_json(path, lengths)
    assert launches == POOLS_PER_FORWARD * n_forwards, (launches,
                                                        n_forwards)
    log(f'videos {len(lengths)}, windows {n_windows}, proposals {n_props}, '
        f'wall {wall:.3f} s, {n_windows / wall:.2f} windows/s (first run, '
        f'includes video load, upload and post-processing)')
    log(f'boundary_max_pool_fwd launches in this run: {launches} '
        f'({n_forwards} forwards x {POOLS_PER_FORWARD})')
    cfg.testing['output_json'] = 'warm.json'
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_test(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    log(f'second (warm) run: wall {wall:.3f} s, {n_windows / wall:.2f} '
        f'windows/s')
    return launches, lengths, n_windows / wall


def profile_device(fn, label: str, top: int = 8) -> float:
    """Kernel time by name over one fn() (torch.profiler), the device's
    busy share of that call's wall time (profiling on), and the same
    device time by the PyTorch op (and input shapes) that launched it.
    Returns the busy ms. Ranges of user annotations (the optimizer's
    `Optimizer.step#...`) overlap the kernels inside them and are left
    out of the sums."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0
            and not getattr(e, 'is_user_annotation', False)]
    busy = sum(r[0] for r in rows)
    if not rows:
        raise RuntimeError(f'profile {label}: the profiler recorded no '
                           'device time')
    log(f'profile {label}: wall {wall_ms:.2f} ms, device busy {busy:.2f} '
        f'ms ({busy / wall_ms:.1%}), {sum(r[1] for r in rows)} kernels')
    for ms, count, key in sorted(rows, reverse=True)[:top]:
        log(f'  {ms:9.3f} ms {ms / busy:6.1%} x{count:<5d} {key[:90]}')
    # a kernel's time is the self device time of the innermost op that
    # launched it, so the op rows add up to the busy time, plus the rows
    # 'Command Buffer Full' (the host waiting for a free launch slot)
    ops = [(e.self_device_time_total / 1e3, e.count, e.key,
            str(e.input_shapes))
           for e in prof.key_averages(group_by_input_shape=True)
           if e.device_type == torch.autograd.DeviceType.CPU
           and e.self_device_time_total > 0]
    log(f'  by op (input shapes): {sum(o[0] for o in ops):.2f} ms')
    for ms, count, key, shapes in sorted(ops, reverse=True)[:top]:
        log(f'  {ms:9.3f} ms {ms / busy:6.1%} x{count:<5d} {key} '
            f'{shapes[:100]}')
    return busy


def phase_throughput(state_dict, root, lengths):
    log(f'== phase 9: forward + decode throughput (bf16) with '
        f'model.stem_pallas off and on, in turns, soft-NMS time, on '
        f'{card_line()}')
    pipes = {stem: InferencePipeline(
        build_model(state_dict, torch.bfloat16, 'cuda', stem_pallas=stem),
        clip_length=FRAMES, stride=128, crop_size=CROP, top_k=5000,
        use_edl=True, os_head=True, device='cuda') for stem in (False, True)}
    for w in (32, 128):
        clips = random_clips(w, seed=2)
        for stem in (False, True):
            pipes[stem].forward_decode(clips)
        ms, mem = {False: 0.0, True: 0.0}, {False: 0.0, True: 0.0}
        # off, on, on, off: the two drift alike with the card and host
        for stem in (False, True, True, False):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms[stem] += time_ms(lambda: pipes[stem].forward_decode(clips),
                                reps=3, warmup=0) / 2
            mem[stem] = max(mem[stem],
                            torch.cuda.max_memory_allocated() / 2**30)
        for stem in (False, True):
            log(f'stem_pallas {stem}: forward+decode W={w}: '
                f'{ms[stem]:.2f} ms, {w / ms[stem] * 1e3:.1f} windows/s, '
                f'peak memory {mem[stem]:.2f} GiB (both models resident)')
        if w == 32:
            for stem in (False, True):
                profile_device(lambda: pipes[stem].forward_decode(clips),
                               f'forward+decode W=32 stem_pallas {stem}')
        del clips
        torch.cuda.empty_cache()
    pipe = pipes[False]
    del pipes[True]
    torch.cuda.empty_cache()
    nms_ms = []
    for name, t in lengths.items():
        data = np.load(os.path.join(root, 'test_npy', name + '.npy'))
        dec, offsets = pipe.decode_video(data, t, max_batch=128)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        props = pipe.post_process_on_device(dec, offsets, 10.0)
        torch.cuda.synchronize()
        nms_ms.append((time.perf_counter() - t0) * 1e3)
        log(f'post-process (top-k preselect + soft-NMS) {name}: '
            f'{len(offsets)} windows, {len(props)} proposals, '
            f'{nms_ms[-1]:.1f} ms')
    log(f'soft-NMS post-process mean per video: '
        f'{sum(nms_ms) / len(nms_ms):.1f} ms')
    profile_device(lambda: pipe.post_process_on_device(dec, offsets, 10.0),
                   f'post-process {name}')


# ---------------------------------------------------------------- training

# pool launches per train step: the main pass's 2, the SSL triplets' 2
# (the frame-level pool; loc and conf lr as one packed call)
TRAIN_STEP_FWD, TRAIN_STEP_BWD = 4, 4


def train_model(cfg, frame: int, crop: int, device, seed: int = 0):
    """The config's BDNet in f32 with the seeded training init."""
    m = factory.init_train_weights(factory.build_model(
        cfg, frame_num=frame, crop_size=crop, dtype=torch.float32),
        seed=seed)
    return m.to(device)


def train_batch(b: int, frame: int, crop: int, seed: int, device):
    """A training batch as the dataset gives it with uint8 ingest: uint8
    clips (made on `device` from a seed), padded GT, heatmaps and the SSL
    inputs."""
    rng = np.random.RandomState(seed)
    n_max = 4
    truths = np.zeros((b, n_max, 2), np.float32)
    labels = np.zeros((b, n_max), np.int64)
    gt_mask = np.zeros((b, n_max), bool)
    for i in range(b):
        k = rng.randint(1, n_max)
        s = rng.uniform(0, 0.7, k)
        truths[i, :k, 0] = s
        truths[i, :k, 1] = np.clip(s + rng.uniform(0.05, 0.3, k), 0, 1)
        labels[i, :k] = rng.randint(1, CLASSES, k)
        gt_mask[i, :k] = True
    props = np.array([[20., 80.], [120., 200.], [90., 110.]],
                     np.float32) * (frame / 256)
    host = {'truths': truths, 'labels': labels, 'gt_mask': gt_mask,
            'scores': (rng.rand(b, 2, frame) > 0.9).astype(np.float32),
            'ssl_props': np.tile(props[None], (b, 1, 1)),
            'ssl_flags': np.ones((b,), np.float32)}
    batch = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
    g = torch.Generator(device=device).manual_seed(seed)
    for k in ('clips', 'ssl_clips'):
        batch[k] = torch.randint(0, 256, (b, frame, crop, crop, 3),
                                 generator=g, device=device,
                                 dtype=torch.uint8)
    return batch


def loss_and_grads(model, cfg, batch, epoch: int = 11):
    """Loss terms and parameter gradients of one train step (no update)."""
    model.train()
    model.zero_grad(set_to_none=True)
    edl = EDLState.create(factory.build_loss_config(cfg).edl, batch[
        'truths'].device)
    cost, terms, _ = compute_losses(model, factory.build_loss_config(cfg),
                                    factory.build_loss_weights(cfg),
                                    device_ingest(batch), edl, epoch)
    cost.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    return {k: v.detach() for k, v in terms.items()}, grads


def capture_train_calls(model, cfg, batch):
    """(x, segments, levels, g) of every boundary-pool call of one full
    train step (g None where the output gets no gradient), in call
    order."""
    calls = []
    real = boundary_pool.boundary_max_pool_segmented

    def recording(x, seg, levels):
        out = real(x, seg, levels)
        rec = {'x': x.detach().clone(), 'seg': seg.clone(),
               'levels': boundary_pool_cuda.check_levels(
                   levels, x.shape[1], seg.shape[1]), 'g': None}
        calls.append(rec)
        if out.requires_grad:
            def hook(g, rec=rec):
                # the kernel's backward takes g as .contiguous() gives it
                rec['g'] = g.detach().clone(
                    memory_format=torch.contiguous_format)
            out.register_hook(hook)
        return out

    pyramid.boundary_max_pool_segmented = recording
    bdnet_mod.boundary_max_pool_segmented = recording
    try:
        loss_and_grads(model, cfg, batch)
    finally:
        pyramid.boundary_max_pool_segmented = real
        bdnet_mod.boundary_max_pool_segmented = real
    torch.cuda.synchronize()
    return calls


def quantized_case(b, c, levels, seed):
    """x on 5 values (ties everywhere), per-level adversarial segments, g
    on a 1/64 grid (float32 sums of it are exact in any order)."""
    gen = torch.Generator(device='cuda').manual_seed(seed)
    t_len, k = (sum(v) for v in zip(*levels))
    x = torch.randint(-2, 3, (b, t_len, c), generator=gen,
                      device='cuda').float()
    g = torch.randint(-256, 257, (b, k, c), generator=gen,
                      device='cuda').float() / 64
    return x, adversarial_levels(b, levels, seed), levels, g


def bwd_bound_ms(g: torch.Tensor, t_len: int) -> float:
    """Least time of one backward: g and the int32 argmax read once, dx
    written once, over the memory rate."""
    b, k, c = g.shape
    nbytes = g.numel() * (g.element_size() + 4) + b * t_len * c * \
        g.element_size()
    return nbytes / HBM_BYTES_PER_S * 1e3


def phase_bwd_kernel_vs_plain(cfg):
    log('== phase 3: grouped boundary_max_pool_bwd (B2) vs plain version '
        'on the card')
    model = train_model(cfg, FRAMES, CROP, 'cuda')
    calls = capture_train_calls(model, cfg, train_batch(1, FRAMES, CROP, 7,
                                                        'cuda'))
    del model
    with_g = [c for c in calls if c['g'] is not None]
    log(f'one full-width bs=1 train step: {len(calls)} pool calls, '
        f'{len(with_g)} with a gradient: ' + ', '.join(
            f'x {tuple(c["x"].shape)} K {c["seg"].shape[1]} '
            f'{len(c["levels"])} levels' for c in with_g))
    assert (len(calls), len(with_g)) == (TRAIN_STEP_FWD, TRAIN_STEP_BWD), \
        (len(calls), len(with_g))
    cases = [(c['x'], c['seg'], c['levels'], c['g'], 'captured')
             for c in with_g]
    for i, c in enumerate(with_g):
        cases.append(quantized_case(c['x'].shape[0], c['x'].shape[2],
                                    c['levels'], 100 + 10 * i) + ('ties',))
    max_err = 0.0
    for i, (x, seg, levels, g, kind) in enumerate(cases):
        for dtype in (torch.float32, torch.bfloat16):
            xd, gd = x.to(dtype).contiguous(), g.to(dtype).contiguous()
            out, am = boundary_pool_cuda.boundary_max_pool_fwd(
                xd, seg, True, levels)
            dx = boundary_pool_cuda.boundary_max_pool_bwd(
                am, gd, x.shape[1], levels)
            want_out, want_am = boundary_pool.plain_forward_segmented(
                xd, seg, levels, True)
            want_dx = boundary_pool.plain_backward_segmented(want_am, gd,
                                                             levels)
            torch.cuda.synchronize()
            if not torch.equal(out, want_out):
                raise AssertionError(f'fwd with argmax != plain: {i} {kind}')
            if not torch.equal(am.long(), want_am):
                raise AssertionError(f'argmax != plain argmax: call {i} '
                                     f'{kind} {dtype}')
            err = (dx.float() - want_dx.float()).abs().max().item()
            max_err = max(max_err, err)
            if kind == 'ties' and not torch.equal(dx, want_dx):
                raise AssertionError(f'dx != plain on tied call {i} {dtype}: '
                                     f'{err}')
            torch.testing.assert_close(
                dx, want_dx, rtol=1e-6, atol=1e-6,
                msg=lambda m: f'dx call {i} {kind} {dtype}: {m}')
    log(f'argmax == plain exactly, dx within rtol 1e-6 / atol 1e-6 on '
        f'{len(with_g)} captured calls and equal on {len(with_g)} tied '
        f'calls, x (f32, bf16); max_abs_err {max_err}')

    # time: the grouped calls of one step against the per-level route
    # (the same kernels through their one-level entry, 27 calls)
    grouped, route = [], []
    for c in with_g:
        x, seg, levels, g = c['x'], c['seg'], c['levels'], c['g']
        _, am = boundary_pool_cuda.boundary_max_pool_fwd(x, seg, True,
                                                         levels)
        grouped.append((x, seg, levels, g, am))
        for xr, sr, gr in per_level_route(x, seg, levels, g):
            _, ar = boundary_pool_cuda.boundary_max_pool_fwd(xr, sr, True)
            route.append((xr, sr, None, gr, ar))
    assert len(route) == 27, len(route)

    def bwd(cs):
        return lambda: [boundary_pool_cuda.boundary_max_pool_bwd(
            am, g, x.shape[1], levels) for x, _, levels, g, am in cs]

    def fwd_train(cs):
        return lambda: [boundary_pool_cuda.boundary_max_pool_fwd(
            x, seg, True, levels) for x, seg, levels, _, _ in cs]

    def plain():
        for x, _, levels, g, am in grouped:
            boundary_pool.plain_backward_segmented(am.long(), g, levels)

    def library():
        for x, _, _, g, am in grouped:
            torch.zeros((g.shape[0], x.shape[1], g.shape[2]), device='cuda'
                        ).scatter_add_(1, am.long(), g)

    dev = in_turns({'route': bwd(route), 'grouped': bwd(grouped)}, 20,
                   device_ms)
    fwd = in_turns({'route': fwd_train(route),
                    'grouped': fwd_train(grouped)}, 20, device_ms)
    # the plain version launches one scatter per k (~400 kernels a step):
    # few reps, so that the queue stays within the sleep kernel's hold
    tot = {'ms': dev['grouped'], 'route_ms': dev['route'],
           'plain_ms': device_ms(plain, reps=1),
           'library_ms': device_ms(library, reps=20),
           'bound_ms': sum(bwd_bound_ms(g, x.shape[1])
                           for x, _, _, g, _ in grouped),
           'fwd_train_ms': fwd['grouped'], 'fwd_train_route_ms': fwd['route'],
           'fwd_train_bound_ms': sum(pool_bound_ms(x, seg, levels, True)
                                     for x, seg, levels, _, _ in grouped)}
    log(f'one train step (bs=1, f32), device ms: B2 grouped, '
        f'{len(grouped)} calls: {tot["ms"]}; per-level route, 27 calls: '
        f'{tot["route_ms"]}; plain {tot["plain_ms"]}; scatter_add_ '
        f'{tot["library_ms"]}; bound (g + argmax + dx) {tot["bound_ms"]} '
        f'({tot["bound_ms"] / tot["ms"]:.3f} of it); B1 with argmax, '
        f'grouped {tot["fwd_train_ms"]}, route {tot["fwd_train_route_ms"]}, '
        f'group bound {tot["fwd_train_bound_ms"]}; {card_line()}')
    del calls, cases, with_g, grouped, route
    torch.cuda.empty_cache()
    return max_err, tot


def phase_train_paths(cfg):
    log('== phase 4: one full-width bs=1 train step, TF32 off: kernel '
        'path vs plain path, card vs CPU')
    with tf32_off():
        model = train_model(cfg, FRAMES, CROP, 'cuda')
        batch = train_batch(1, FRAMES, CROP, 3, 'cuda')
        f0, b0 = boundary_pool_cuda.LAUNCHES, boundary_pool_cuda.BWD_LAUNCHES
        terms_k, grads_k = loss_and_grads(model, cfg, batch)
        torch.cuda.synchronize()
        fwd = boundary_pool_cuda.LAUNCHES - f0
        bwd = boundary_pool_cuda.BWD_LAUNCHES - b0
        with boundary_pool.force_plain():
            terms_p, grads_p = loss_and_grads(model, cfg, batch)
        torch.cuda.synchronize()
        assert (fwd, bwd) == (TRAIN_STEP_FWD, TRAIN_STEP_BWD), (fwd, bwd)
        for k in terms_k:
            if not torch.equal(terms_k[k], terms_p[k]):
                raise AssertionError(f'{k}: kernel path {terms_k[k]} != '
                                     f'plain path {terms_p[k]}')
        assert set(grads_k) == set(grads_p)
        worst = 0.0
        for n, gk in grads_k.items():
            gp = grads_p[n]
            scale = gp.abs().max().item()
            torch.testing.assert_close(gk, gp, rtol=1e-5, atol=1e-5 * scale,
                                       msg=lambda m: f'grad {n}: {m}')
            if scale > 0:
                worst = max(worst, (gk - gp).abs().max().item() / scale)
        log(f'kernel path: {fwd} B1 + {bwd} B2 launches per step; losses '
            f'equal the plain path\'s bit for bit; every gradient within '
            f'rtol 1e-5 (+ 1e-5 of its max); worst |diff| / max {worst:.3g}; '
            f'cost {terms_k["cost"].item():.6f}')
        del model, grads_p
        torch.cuda.empty_cache()

        # the same full-width step on the CPU (its time is printed: past
        # 60 s this check would move to a smaller size)
        cpu_model = train_model(cfg, FRAMES, CROP, 'cpu')
        t0 = time.perf_counter()
        terms_c, grads_c = loss_and_grads(
            cpu_model, cfg, {k: v.cpu() for k, v in batch.items()})
        cpu_s = time.perf_counter() - t0
        for k in terms_c:
            torch.testing.assert_close(terms_k[k].cpu(), terms_c[k],
                                       rtol=1e-3, atol=2e-3,
                                       msg=lambda m: f'{k}: {m}')
        gn_d = global_norm(grads_k.values()).item()
        gn_c = global_norm(grads_c.values()).item()
        torch.testing.assert_close(torch.tensor(gn_d), torch.tensor(gn_c),
                                   rtol=1e-3, atol=2e-3)
        log(f'card == CPU on every loss term and the global grad norm '
            f'(rtol 1e-3, atol 2e-3) at full width, bs=1: cost '
            f'{terms_k["cost"].item():.6f} vs {terms_c["cost"].item():.6f}, '
            f'grad norm {gn_d:.6f} vs {gn_c:.6f}; CPU step {cpu_s:.1f} s')
        del batch, grads_k, cpu_model, grads_c


def phase_train_end_to_end(root):
    log('== phase 7: training end to end (tools.train, full width, '
        'synthetic videos): 2 epochs, checkpoint, resume, run_test')
    data = os.path.join(root, 'train_synth')
    cfg_path = make_synthetic_dataset(data, n_train=3, n_test=1,
                                      clip_length=FRAMES, crop_size=CROP,
                                      spatial=112, seed=0)
    cfg = load_config(cfg_path, overrides={'training.max_epoch': 2})
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = train_loop(cfg, max_steps_per_epoch=2)
    ckdir = cfg.training.checkpoint_path
    # the loop saves from epoch 11 on: this state is saved as epoch 10 and
    # the CLI resumes it for epoch 11, which saves itself
    checkpoint.save(ckdir, SAVE_AFTER_EPOCH, state)
    train_cli.main([cfg_path, '--max_steps_per_epoch', '2', '--resume',
                    '-1', '--max_epoch', str(SAVE_AFTER_EPOCH + 1)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd, bwd = boundary_pool_cuda.LAUNCHES, boundary_pool_cuda.BWD_LAUNCHES
    assert pack_launches() == 0, 'stem pack with model.stem_pallas off'
    assert checkpoint.latest_epoch(ckdir) == SAVE_AFTER_EPOCH + 1
    payload = torch.load(checkpoint.epoch_path(ckdir, SAVE_AFTER_EPOCH + 1),
                         map_location='cpu', weights_only=True)
    steps = payload['step']
    assert state.step >= 2 and steps > state.step, (state.step, steps)
    with open(os.path.join(ckdir, 'metrics.jsonl')) as f:
        recs = [json.loads(line) for line in f]
    assert [r['step'] for r in recs] == list(range(1, steps + 1))
    for r in recs:
        assert all(math.isfinite(v) for v in r.values()), r
    assert (fwd, bwd) == (TRAIN_STEP_FWD * steps, TRAIN_STEP_BWD * steps), \
        (fwd, bwd)
    log(f'{steps} steps over epochs 1, 2 and (resumed) 11 in {wall:.1f} s '
        f'(data and checkpoints included); costs '
        f'{[round(r["cost"], 4) for r in recs]}; launches in this run: '
        f'B1 {fwd}, B2 {bwd} ({TRAIN_STEP_FWD} and {TRAIN_STEP_BWD} per '
        f'step)')
    test_cfg = load_config(cfg_path)
    path = run_test(test_cfg)
    with open(path) as f:
        results = json.load(f)['results']
    n = sum(len(v) for v in results.values())
    assert len(results) == 1 and n > 0, (len(results), n)
    for props in results.values():
        for p in props:
            assert all(math.isfinite(v) for v in
                       [p['score'], p['uncertainty'], *p['segment']]), p
    log(f'run_test on the trained checkpoint: {n} proposals, finite')
    return fwd, bwd, cfg_path


def phase_train_speed(cfg):
    log(f'== phase 8: train step time (f32, full width) with '
        f'model.stem_pallas off and on, in turns, on {card_line()}')
    loss_cfg = factory.build_loss_config(cfg)
    weights = factory.build_loss_weights(cfg)
    states = {}
    for stem in (False, True):
        model = train_model(load_config(CONFIG, overrides={
            'model.stem_pallas': stem}), FRAMES, CROP, 'cuda')
        states[stem] = TrainState(
            model=model, optimizer=make_optimizer(model, 1e-5, 1e-3),
            edl_state=EDLState.create(loss_cfg.edl, 'cuda'))
    out = {}
    for bs, reps in ((1, 6), (8, 3)):
        batch = train_batch(bs, FRAMES, CROP, 5, 'cuda')

        def step(stem):
            train_step(states[stem], loss_cfg, weights, batch, 11)

        for stem in (False, True):
            step(stem)
        ms, mem = {False: 0.0, True: 0.0}, {False: 0.0, True: 0.0}
        # off, on, on, off: the host-bound step drifts with the host
        for stem in (False, True, True, False):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            for _ in range(reps):
                step(stem)
            torch.cuda.synchronize()
            ms[stem] += (time.perf_counter() - t0) * 1e3 / reps / 2
            mem[stem] = max(mem[stem],
                            torch.cuda.max_memory_allocated() / 2**30)
        for stem in (False, True):
            out[(stem, bs)] = (ms[stem], mem[stem])
            log(f'stem_pallas {stem}, bs={bs}: {ms[stem]:.1f} ms per step, '
                f'{bs / ms[stem] * 1e3:.2f} clips/s, peak memory '
                f'{mem[stem]:.2f} GiB (both models\' states resident)')
        for stem in (False, True):
            busy = profile_device(lambda: step(stem),
                                  f'train step bs={bs} stem_pallas {stem}',
                                  top=10)
            log(f'bs={bs} stem_pallas {stem}: device busy {busy:.2f} ms of '
                f'the {ms[stem]:.1f} ms step without the profiler '
                f'({busy / ms[stem]:.1%})')
        del batch
        torch.cuda.empty_cache()
    del states
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------- the space-to-depth stem

STEM_KERNEL = (7, 7, 7)
STEM_CFG = {'model.stem_pallas': True}


def pack_launches() -> int:
    return stem_pack_cuda.V1_LAUNCHES + stem_pack_cuda.V2_LAUNCHES


def reset_counts():
    boundary_pool_cuda.LAUNCHES = boundary_pool_cuda.BWD_LAUNCHES = 0
    stem_pack_cuda.V1_LAUNCHES = stem_pack_cuda.V2_LAUNCHES = 0


def pack_bound_ms(xp: torch.Tensor, a_t: int = 4) -> float:
    """Least time for one pack: every element of xp read once (the taps
    of the t_out frames cover all of it) and z written once, over the
    memory rate."""
    b, tp, hp, wp, c = xp.shape
    z = b * (tp // 2 - a_t + 1) * hp * wp * 2 * a_t * c
    return (xp.numel() + z) * xp.element_size() / HBM_BYTES_PER_S * 1e3


PACKS = {   # name: (kernel, plain version, keyword arguments)
    'v1': (stem_pack_cuda.stem_pack96, stem_pack.stem_pack96_plain, {}),
    'v2 fp=1': (stem_pack_cuda.stem_pack96_v2,
                stem_pack.stem_pack96_v2_plain, {'fp': 1}),
    'v2 fp=2': (stem_pack_cuda.stem_pack96_v2,
                stem_pack.stem_pack96_v2_plain, {'fp': 2}),
}


def pack_cases(clips):
    """(label, xp) inputs of phase 10: the W=32 batch as the model hands
    it over (the frame plan's bulk copies) and its contiguous copy
    (strided loads); a plane too large for shared memory in one piece
    (Hp = Wp = 230, in bands of rows); t_out = 1 (every frame feeds one
    destination); a first plane off 16-byte alignment (storage offset 1);
    odd h2 * wq (runs that start off 16-byte alignment); Hp not a
    multiple of 8 and Wp != Hp; f32 and bf16."""
    g = torch.Generator(device='cuda').manual_seed(11)

    def view(shape, dtype, offset=0):    # (B, Tp, Hp, Wp, C) of BCTHW
        b, t, h, w, c = shape
        buf = torch.randn(b * c * t * h * w + offset, generator=g,
                          device='cuda').to(dtype)
        return buf[offset:].view(b, c, t, h, w).permute(0, 2, 3, 4, 1)

    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        xp = layers.space_to_depth_pad(clips.to(dtype), STEM_KERNEL)
        big = view((2, 10, 230, 230, 3), dtype)
        cases += [(f'W=32 model view {dtype}', xp),
                  (f'W=32 contiguous {dtype}', xp.contiguous()),
                  (f'(2, 10, 230, 230, 3) view {dtype}', big),
                  (f'(2, 10, 230, 230, 3) contiguous {dtype}',
                   big.contiguous()),
                  (f'(2, 8, 10, 14, 3) t_out=1 view {dtype}',
                   view((2, 8, 10, 14, 3), dtype)),
                  (f'(3, 22, 10, 14, 3) view at offset 1 {dtype}',
                   view((3, 22, 10, 14, 3), dtype, 1)),
                  (f'(3, 22, 10, 14, 3) {dtype}', torch.randn(
                      (3, 22, 10, 14, 3), generator=g, device='cuda').to(
                      dtype)),
                  (f'(2, 18, 26, 38, 3) view {dtype}',
                   view((2, 18, 26, 38, 3), dtype))]
    return cases


def phase_stem_pack_vs_plain(clips):
    log('== phase 10: stem pack kernel (B3 v1, B4 v2) vs plain version')
    cases = pack_cases(clips)
    err = {'v1': 0.0, 'v2': 0.0}
    plans = set()
    for label, xp in cases:
        for name, (kernel, plain, kw) in PACKS.items():
            if (xp.shape[1] // 2 - 3) % kw.get('fp', 1):
                continue
            plans.add(stem_pack_cuda.plan(xp, kw.get('fp', 1),
                                          int(name != 'v1')))
            got, want = kernel(xp, **kw), plain(xp, **kw)
            diff = (got.float() - want.float()).abs().max().item()
            err[name[:2]] = max(err[name[:2]], diff)
            if not torch.equal(got, want):
                raise AssertionError(f'{name} kernel != plain on {label}: '
                                     f'max |diff| {diff}')
            lib = stem_pack.stem_pack_strided(xp, layout=name[:2], **kw)
            if not torch.equal(lib, want):
                raise AssertionError(f'{name} strided copy != plain on '
                                     f'{label}')
            del got, want, lib
    assert plans == set(stem_pack_cuda.PATHS), plans
    log(f'kernel == plain == strided copy exactly (torch.equal) on '
        f'{len(cases)} inputs x {{{", ".join(PACKS)}}} (where t_out '
        f'splits into fp), through every plan {sorted(plans)}; '
        f'max_abs_err {err}')
    del cases
    torch.cuda.empty_cache()

    # times at the main paths' inputs: inference packs the W-window
    # batch in bf16 (v2), training the bs=1 or bs=8 batch in f32 (v1)
    times = {}
    log(f'per call, device ms: kernel, plain, library (the strided view\'s '
        f'.contiguous()), bound (xp + z bytes / 3.35 TB/s), and for v2 the '
        f'tile plan (v1\'s design) on the same input; xp (B, 262, 102, '
        f'102, 3) as the model hands it over; {card_line()}')
    for name, dtype, b in (('v2 fp=1', torch.bfloat16, 32),
                           ('v2 fp=1', torch.bfloat16, 128),
                           ('v1', torch.bfloat16, 32),
                           ('v2 fp=1', torch.float32, 32),
                           ('v1', torch.float32, 32),
                           ('v1', torch.float32, 1),
                           ('v1', torch.float32, 8)):
        src = clips if b <= len(clips) else random_clips(b, seed=3)
        xp = layers.space_to_depth_pad(src[:b].to(dtype), STEM_KERNEL)
        del src
        kernel, plain, kw = PACKS[name]
        r = {'ms': device_ms(lambda: kernel(xp, **kw), reps=20),
             'plain_ms': device_ms(lambda: plain(xp, **kw), reps=3),
             'library_ms': device_ms(lambda: stem_pack.stem_pack_strided(
                 xp, layout=name[:2], **kw), reps=10),
             'bound_ms': pack_bound_ms(xp)}
        line = (f'  {name:8s} {str(dtype):15s} B={b:<3d} kernel '
                f'{r["ms"]:.4f}  plain {r["plain_ms"]:.4f}  library '
                f'{r["library_ms"]:.4f}  bound {r["bound_ms"]:.4f}  '
                f'bound/kernel {r["bound_ms"] / r["ms"]:.3f}')
        if name != 'v1':
            # the tile plan (v1's design) on the same input, and the card's
            # own rate for a contiguous copy of z (read z, write z) as the
            # ceiling
            r['tile_ms'] = device_ms(lambda: stem_pack_cuda._launch(
                xp, 4, 1, 1, path='tile'), reps=20)
            z = kernel(xp, **kw)
            clone_ms = device_ms(z.clone, reps=10)
            rate = r['bound_ms'] * HBM_BYTES_PER_S / 1e12 / r['ms']
            line += (f'  tile plan {r["tile_ms"]:.4f}  z.clone() '
                     f'{clone_ms:.4f} ({2 * z.nbytes / clone_ms / 1e9:.3f} '
                     f'TB/s; kernel {rate:.3f} TB/s)')
            del z
        times[(name[:2], dtype, b)] = r
        log(line)
        del xp
        torch.cuda.empty_cache()
    return err, times


def phase_stem_layouts(clips, weight):
    log('== phase 11: the stem convolution at W=32: plain Conv3d (cuDNN) '
        'vs pack + F.conv2d in each layout')
    flags = torch.backends.cudnn.allow_tf32
    out = {}
    try:
        for dtype, tf32 in ((torch.bfloat16, flags), (torch.float32, False),
                            (torch.float32, True)):
            torch.backends.cudnn.allow_tf32 = tf32
            x, w = clips.to(dtype), weight.to(dtype)
            xp = layers.space_to_depth_pad(x, STEM_KERNEL)
            pads = layers._f_pad(x.shape[2:], STEM_KERNEL, (2, 2, 2))
            fns = {'Conv3d': lambda: F.conv3d(F.pad(x, pads), w, stride=2),
                   'v2 NCHW': lambda: stem_pack.stem_conv_v2(xp, w),
                   'v1 channels_last': lambda: stem_pack.stem_conv_v1(xp, w)}
            tag = f'{dtype}' + (', TF32' if tf32 and dtype == torch.float32
                                else '')
            with torch.inference_mode():
                ys = {k: f() for k, f in fns.items()}
                for k in ('v2 NCHW', 'v1 channels_last'):
                    diff = (ys[k].float() - ys['Conv3d'].float()).abs().max()
                    log(f'  {tag}: {k} vs Conv3d max |diff| {diff.item():.3g}')
                    if dtype == torch.float32 and not tf32:
                        torch.testing.assert_close(ys[k], ys['Conv3d'],
                                                   rtol=1e-3, atol=2e-3)
                del ys
                for k, f in fns.items():
                    out[(k, tag)] = time_ms(f, reps=5, warmup=2)
            log(f'  {tag}: ' + ', '.join(f'{k} {out[(k, tag)]:.3f} ms'
                                         for k in fns))
        # the training side: forward + weight gradient at bs=1 and bs=8,
        # f32 with PyTorch's default TF32 convolutions (the pack has no
        # gradient)
        torch.backends.cudnn.allow_tf32 = flags
        w = weight.clone().requires_grad_(True)
        for bs in (1, 8):
            x = clips[:bs]
            xp = layers.space_to_depth_pad(x, STEM_KERNEL)
            pads = layers._f_pad(x.shape[2:], STEM_KERNEL, (2, 2, 2))
            gy = torch.randn((bs, 64, 128, 48, 48), device='cuda')
            fns = {'Conv3d': lambda: F.conv3d(F.pad(x, pads), w, stride=2),
                   'v2 NCHW': lambda: stem_pack.stem_conv_v2(xp, w),
                   'v1 channels_last': lambda: stem_pack.stem_conv_v1(xp,
                                                                      w)}
            tag = f'train bs={bs}'
            # in turns (Conv3d, v2, v1, v1, v2, Conv3d): the two layouts
            # are close here
            for k in list(fns) + list(fns)[::-1]:
                ms = time_ms(lambda: fns[k]().backward(gy), reps=10,
                             warmup=2)
                out[(k, tag)] = out.get((k, tag), 0.0) + ms / 2
            log(f'  forward + weight gradient, bs={bs} f32 (TF32 as '
                'default): ' + ', '.join(f'{k} {out[(k, tag)]:.3f} ms'
                                         for k in fns))
    finally:
        torch.backends.cudnn.allow_tf32 = flags
        torch.cuda.empty_cache()
    return out


def phase_full_width_stem(state_dict):
    log('== phase 12: full-width BDNet f32, TF32 off, model.stem_pallas on')
    with tf32_off():
        model = build_model(state_dict, torch.float32, 'cuda',
                            stem_pallas=True)
        clips = random_clips(32, seed=1)
        with torch.inference_mode():
            dev1 = model(clips[:1])
        cpu_model = build_model(state_dict, torch.float32, 'cpu',
                                stem_pallas=True)
        t0 = time.perf_counter()
        with torch.inference_mode():
            ref1 = cpu_model(clips[:1].cpu())
        log(f'CPU forward W=1 (plain pack): {time.perf_counter() - t0:.1f} '
            's')
        for key in OUT_KEYS:
            got, want = dev1[key].float().cpu(), ref1[key].float()
            assert got.shape == want.shape, (key, got.shape, want.shape)
            assert torch.isfinite(got).all(), key
            torch.testing.assert_close(got, want, rtol=1e-3, atol=2e-3,
                                       msg=lambda m: f'{key}: {m}')
        log('flag on: card == CPU at W=1 (rtol 1e-3, atol 2e-3) on every '
            'out key')
        off = build_model(state_dict, torch.float32, 'cuda')
        reset_counts()
        with torch.inference_mode():
            out_on = model(clips)
        launches = (stem_pack_cuda.V1_LAUNCHES, stem_pack_cuda.V2_LAUNCHES)
        with torch.inference_mode():
            out_off = off(clips)
        torch.cuda.synchronize()
        assert launches == (0, 1), f'pack launches (v1, v2) {launches}'
        worst = 0.0
        for key in OUT_KEYS:
            torch.testing.assert_close(out_on[key], out_off[key], rtol=1e-3,
                                       atol=2e-3, msg=lambda m: f'{key}: {m}')
            worst = max(worst, (out_on[key] - out_off[key]).abs().max()
                        .item())
        log(f'W=32: flag on == flag off (rtol 1e-3, atol 2e-3) on every out '
            f'key, worst |diff| {worst:.3g}; pack launches per forward '
            f'(v1, v2) {launches}')
        del model, cpu_model, off, out_on, out_off, clips


def phase_end_to_end_stem(root, lengths, warm_off):
    log('== phase 13: inference end to end with model.stem_pallas on '
        '(tools.test.run_test, bf16)')
    cfg = synthetic_test_config(root, **dict(STEM_CFG, **{
        'testing.output_json': 'stem_pallas.json'}))
    n_forwards = forwards_of(lengths)
    n_windows = sum(len(window_offsets(t, FRAMES, 128))
                    for t in lengths.values())
    reset_counts()
    path = run_test(cfg)
    torch.cuda.synchronize()
    counts = (stem_pack_cuda.V1_LAUNCHES, stem_pack_cuda.V2_LAUNCHES,
              boundary_pool_cuda.LAUNCHES, boundary_pool_cuda.BWD_LAUNCHES)
    n_props = check_detection_json(path, lengths)
    assert counts == (0, n_forwards, POOLS_PER_FORWARD * n_forwards, 0), \
        counts
    log(f'{n_props} proposals; launches in this run: stem pack (v1, v2) '
        f'{counts[:2]}, B1 {counts[2]} ({n_forwards} forwards)')
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_test(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    log(f'second (warm) run: wall {wall:.3f} s, {n_windows / wall:.2f} '
        f'windows/s (flag off: {warm_off:.2f})')
    return counts[1]


def stem_grads(model, cfg, batch):
    """Loss terms and gradients of one step (`loss_and_grads`), with the
    stem module and the input and upstream gradient of its main-pass
    call."""
    stem = model.backbone._model.Conv3d_1a_7x7
    seen = {}

    def capture(mod, args, out):
        if 'x' not in seen:
            seen['x'] = args[0].detach()
            out.register_hook(lambda g: seen.setdefault('g', g.detach()))
    hook = stem.register_forward_hook(capture)
    try:
        terms, grads = loss_and_grads(model, cfg, batch)
    finally:
        hook.remove()
    return terms, grads, (stem, seen['x'], seen['g'])


def phase_train_paths_stem(cfg):
    log('== phase 14: one full-width bs=1 train step, f32, TF32 off: '
        'model.stem_pallas on vs off')
    key = 'backbone._model.Conv3d_1a_7x7.conv3d.weight'
    with tf32_off():
        batch = train_batch(1, FRAMES, CROP, 3, 'cuda')
        on_cfg = load_config(CONFIG, overrides=STEM_CFG)
        reset_counts()
        terms_on, grads_on, _ = stem_grads(
            train_model(on_cfg, FRAMES, CROP, 'cuda'), on_cfg, batch)
        torch.cuda.synchronize()
        launches = (stem_pack_cuda.V1_LAUNCHES, stem_pack_cuda.V2_LAUNCHES)
        assert launches == (2, 0), f'pack launches (v1, v2) {launches}'
        terms_off, grads_off, (stem, x, g) = stem_grads(
            train_model(cfg, FRAMES, CROP, 'cuda'), cfg, batch)
        for k in terms_off:
            torch.testing.assert_close(terms_on[k], terms_off[k], rtol=1e-3,
                                       atol=2e-3, msg=lambda m: f'{k}: {m}')
        gn_on = global_norm(grads_on.values()).item()
        gn_off = global_norm(grads_off.values()).item()
        torch.testing.assert_close(torch.tensor(gn_on), torch.tensor(gn_off),
                                   rtol=1e-3, atol=2e-3)
        # over the whole step, the conv's other summation order flips
        # near-tied max-pool and ReLU choices downstream (as any 1e-7
        # change of the input does; tests/test_torch_stem_slice.py): the
        # stem gradient is held in norm (6.5e-3 measured on an H100)
        d = grads_on[key] - grads_off[key]
        rel = (d.norm() / grads_off[key].norm()).item()
        assert rel < 2e-2, rel
        # on the same upstream gradient, the stem's own gradient
        wg = []
        for s2d in (True, False):
            mod = copy.deepcopy(stem)
            mod.space_to_depth = s2d
            mod.zero_grad()
            (mod(x) * g).sum().backward()
            wg.append(mod.conv3d.weight.grad)
        scale = wg[1].abs().max().item()
        torch.testing.assert_close(wg[0], wg[1], rtol=1e-3,
                                   atol=1e-3 * scale)
        log(f'losses within rtol 1e-3 / atol 2e-3 (cost '
            f'{terms_on["cost"].item():.6f} vs {terms_off["cost"].item():.6f}'
            f'), global grad norm {gn_on:.6f} vs {gn_off:.6f}; stem '
            f'gradient over the step |diff| / |off| {rel:.3g}, on the same '
            f'upstream gradient within rtol 1e-3 (+1e-3 of its max, worst '
            f'|diff| / max {(wg[0] - wg[1]).abs().max().item() / scale:.3g})'
            f'; pack launches per step (v1, v2) {launches}')


def phase_train_end_to_end_stem(root, cfg_path):
    log('== phase 15: training end to end (train.loop.train) with '
        'model.stem_pallas on: 1 epoch of at most 2 steps')
    ckdir = os.path.join(root, 'ckpt_stem_pallas')
    cfg = load_config(cfg_path, overrides=dict(STEM_CFG, **{
        'training.max_epoch': 1, 'training.checkpoint_path': ckdir}))
    reset_counts()
    state = train_loop(cfg, max_steps_per_epoch=2)
    torch.cuda.synchronize()
    counts = (stem_pack_cuda.V1_LAUNCHES, stem_pack_cuda.V2_LAUNCHES,
              boundary_pool_cuda.LAUNCHES, boundary_pool_cuda.BWD_LAUNCHES)
    steps = state.step
    with open(os.path.join(ckdir, 'metrics.jsonl')) as f:
        recs = [json.loads(line) for line in f]
    assert steps >= 1 and [r['step'] for r in recs] == list(
        range(1, steps + 1)), (steps, recs)
    for r in recs:
        assert all(math.isfinite(v) for v in r.values()), r
    assert counts == (2 * steps, 0, TRAIN_STEP_FWD * steps,
                      TRAIN_STEP_BWD * steps), counts
    log(f'{steps} steps, costs {[round(r["cost"], 4) for r in recs]}; '
        f'launches in this run: stem pack (v1, v2) {counts[:2]} (2 per '
        f'step: the main and SSL passes), B1 {counts[2]}, B2 {counts[3]}')
    return counts[0]


# ------------------------------- packed ingest, fusion and calibration

PACKED_LENGTHS = (200, 700, 1100, 1500, 1900, 2300, 2700, 3100, 33000)
PACKED_SPATIAL = 100
F32_SUBSET = 4                    # the f32 phase's videos: the first four
FUSED_POOLS = 2 * POOLS_PER_FORWARD


def write_packed_dataset(root: str, seed: int = 3):
    """The packed phases' videos: PACKED_LENGTHS frames at 100 x 100
    (center-cropped to 96), uint8 RGB and 2-channel flow one frame
    shorter, each frame shifted by a brightness ramp along the video; one
    video is shorter than a clip, the first eight share one flush of
    16384 frames and the last (33000 frames) takes a flush of 3 x 16384
    alone. Returns ({'rgb', 'flow'} directories, {name: (frames,
    sample_count, flow frames)})."""
    g = torch.Generator().manual_seed(seed)
    dirs = {k: os.path.join(root, f'packed_{k}') for k in ('rgb', 'flow')}
    # frames drawn from a pool of 2048 random frames per stream (cheaper
    # than 2.3 GB of fresh random bytes), each shifted by the ramp
    pools = {ch: torch.randint(0, 200, (2048, PACKED_SPATIAL,
                                        PACKED_SPATIAL, ch), generator=g,
                               dtype=torch.uint8) for ch in (2, 3)}
    rows = ['video,fps,sample_fps,count,sample_count']
    videos = {}
    for v, t in enumerate(PACKED_LENGTHS):
        name = f'video_packed_{v:03d}'
        for key, ch, n in (('rgb', 3, t), ('flow', 2, t - 1)):
            os.makedirs(dirs[key], exist_ok=True)
            x = pools[ch][torch.randint(0, 2048, (n,), generator=g)]
            x += (torch.arange(n) * 55 // max(n - 1, 1)).to(
                torch.uint8)[:, None, None, None]
            np.save(os.path.join(dirs[key], name + '.npy'), x.numpy())
            del x
        rows.append(f'{name},30.0,10.0,{t * 3},{t}')
        videos[name] = (t, t, t - 1)
    for tag, keep in (('packed', len(rows)), ('subset', F32_SUBSET + 1)):
        with open(os.path.join(root, f'{tag}_info.csv'), 'w') as f:
            f.write('\n'.join(rows[:keep]) + '\n')
    return dirs, videos


def packed_overrides(root, dirs, info='packed_info.csv'):
    """The shipped config's keys for the packed videos as both the test
    and the training set, with the RGB and flow checkpoints."""
    return {
        'dataset.class_info_path': os.path.join(root, 'classes.txt'),
        'dataset.testing.video_info_path': os.path.join(root, info),
        'dataset.testing.video_data_path': dirs['rgb'],
        'dataset.training.video_info_path': os.path.join(root, info),
        'dataset.training.video_data_path': dirs['rgb'],
        'testing.checkpoint_path': os.path.join(root, 'checkpoint-1.ckpt'),
        'testing.flow_checkpoint_path': os.path.join(root, 'flow.ckpt'),
        'testing.rgb_data_path': dirs['rgb'],
        'testing.flow_data_path': dirs['flow'],
        'training.rgb_data_path': dirs['rgb'],
        'training.flow_data_path': dirs['flow'],
        'testing.output_path': os.path.join(root, 'out_packed'),
    }


def counts():
    return (boundary_pool_cuda.LAUNCHES, boundary_pool_cuda.BWD_LAUNCHES,
            stem_pack_cuda.V1_LAUNCHES, stem_pack_cuda.V2_LAUNCHES)


def timed_run(cfg):
    """run_test(cfg) from zeroed launch counts: (JSON path, wall s,
    counts (B1, B2, v1 pack, v2 pack), peak GiB)."""
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    path = run_test(cfg)
    torch.cuda.synchronize()
    return (path, time.perf_counter() - t0, counts(),
            torch.cuda.max_memory_allocated() / 2**30)


def busy_share(fn, label: str) -> float:
    """The device's busy share of one fn(): the union of the intervals in
    which any kernel, copy or fill ran on the card (torch.profiler, CUDA
    activity only, every thread and stream; inference records no
    annotation ranges), over the wall time with the profiler on. Reads the profiler's raw events: building its event
    tree for the ~10^6 launches of a dataset run takes minutes."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == torch.autograd.DeviceType.CUDA)
    busy_ns, end = 0, None
    for start, stop in spans:
        if end is None or start > end:
            busy_ns += stop - start
            end = stop
        elif stop > end:
            busy_ns += stop - end
            end = stop
    if not spans:
        raise RuntimeError(f'{label}: the profiler recorded no device time')
    busy = busy_ns / 1e6
    log(f'profile {label}: wall {wall_ms:.1f} ms (profiling on), device '
        f'busy {busy:.1f} ms ({busy / wall_ms:.1%}), {len(spans)} device '
        f'events')
    return busy / wall_ms


def timed_parts(cfg, label: str) -> dict:
    """One run_test(cfg), no profiler, with its parts timed: each window
    gather (`device_windows`) and each forward + decode
    (`InferencePipeline.forward_decode`) as the span between two CUDA
    events recorded around its launches on the compute stream (device
    time, including any gap in which the stream waited for the host),
    and each video's post-processing (`_finish_packed`) on the host clock
    from a synchronize (its first read of the rows would wait for the
    stream there anyway) to its proposals. Returns seconds per part and
    the wall."""
    spans = {'gather': [], 'forward': []}
    post = []
    real = (pipeline_mod.device_windows, InferencePipeline.forward_decode,
            InferencePipeline._finish_packed)

    def evented(key, fn):
        def run(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **kw)
            stop.record()
            spans[key].append((start, stop))
            return out
        return run

    def finish(self, vid, results):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real[2](self, vid, results)
        post.append(time.perf_counter() - t0)

    pipeline_mod.device_windows = evented('gather', real[0])
    InferencePipeline.forward_decode = evented('forward', real[1])
    InferencePipeline._finish_packed = finish
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_test(cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        (pipeline_mod.device_windows, InferencePipeline.forward_decode,
         InferencePipeline._finish_packed) = real
    out = {key: sum(a.elapsed_time(b) for a, b in ev) / 1e3
           for key, ev in spans.items()}
    out['post'] = sum(post)
    out['wall'] = wall
    rest = wall - out['gather'] - out['forward'] - out['post']
    log(f'parts {label}: wall {wall:.4f} s; {len(spans["gather"])} '
        f'gathers {out["gather"]:.4f} s, {len(spans["forward"])} forward + '
        f'decode {out["forward"]:.4f} s (CUDA events; '
        f'{out["forward"] / wall:.1%} of the wall), post-processing of '
        f'{len(post)} videos {out["post"]:.4f} s on the host '
        f'({out["post"] / wall:.1%}), the rest {rest:.4f} s')
    return out


def pair_proposals(want, got):
    """Pairs of two equal-length proposal lists: both sorted by (label,
    -score); runs of near-tied scores (gap <= 1e-5) re-sorted by segment
    (`opental_tpu/utils/propmatch.py` pair_proposals)."""
    assert len(want) == len(got), (len(want), len(got))
    key = lambda p: (p['label'], -p['score'])  # noqa: E731
    want, got = sorted(want, key=key), sorted(got, key=key)
    pairs, i = [], 0
    while i < len(want):
        j = i + 1
        while (j < len(want) and want[j]['label'] == want[i]['label']
               and want[j - 1]['score'] - want[j]['score'] <= 1e-5):
            j += 1
        seg = lambda p: tuple(p['segment'])  # noqa: E731
        pairs += zip(sorted(want[i:j], key=seg), sorted(got[i:j], key=seg))
        i = j
    return pairs


def assert_same_json(want_path, got_path, label: str, rtol: float = 1e-4,
                     atol: float = 0.0, seg_atol: float = 1e-4) -> float:
    """tests/test_packed_inference.py::_assert_same on every video of two
    detection JSONs: equal counts, each pair of the same class with score
    and segment at rtol 1e-4 (segments atol 1e-4), or the tolerances
    given. Returns the largest relative score difference."""
    with open(want_path) as f:
        want = json.load(f)['results']
    with open(got_path) as f:
        got = json.load(f)['results']
    assert set(want) == set(got), label
    worst = 0.0
    for name in want:
        assert len(want[name]) == len(got[name]), (label, name,
                                                   len(want[name]),
                                                   len(got[name]))
        for a, b in pair_proposals(want[name], got[name]):
            assert a['label'] == b['label'], (label, name, a, b)
            np.testing.assert_allclose(a['score'], b['score'], rtol=rtol,
                                       atol=atol, err_msg=f'{label} {name}')
            np.testing.assert_allclose(a['segment'], b['segment'],
                                       rtol=1e-4, atol=seg_atol,
                                       err_msg=f'{label} {name}')
            worst = max(worst, abs(a['score'] - b['score'])
                        / max(abs(b['score']), 1e-30))
    return worst


def phase_packed(root, dirs, videos):
    log(f'== phase 16: packed device ingest at full width (run_test, '
        f'shipped defaults: bf16, packed_batch {PACKED_BATCH}, '
        f'packed_frames {PACKED_FRAMES}) on {len(videos)} videos, and the '
        f'same videos one at a time (testing.packed: false), in turns; '
        f'{card_line()}')
    forwards, full, flushes, n_windows = ingest_plan(
        [(t, c, 0) for t, c, _ in videos.values()])
    assert flushes >= 2 and full >= 2 and forwards > full, \
        (forwards, full, flushes)
    cfgs = {'packed': load_config(CONFIG, overrides=dict(
        packed_overrides(root, dirs), **{'testing.output_json':
                                         'packed.json'})),
            'per_video': load_config(CONFIG, overrides=dict(
                packed_overrides(root, dirs), **{
                    'testing.packed': False,
                    'testing.output_json': 'per_video.json'}))}
    path, wall, cnt, peak = timed_run(cfgs['packed'])
    n_props = check_detection_json(path, videos)
    assert cnt == (POOLS_PER_FORWARD * forwards, 0, 0, 0), (cnt, forwards)
    launches = cnt[0]
    log(f'{n_windows} windows in {flushes} flushes, {forwards} forwards of '
        f'{PACKED_BATCH} (at least {full} full); B1 launches {cnt[0]} '
        f'({POOLS_PER_FORWARD} per forward); {n_props} proposals; first '
        f'run {wall:.3f} s, {n_windows / wall:.2f} windows/s, peak '
        f'{peak:.2f} GiB')
    walls = {'packed': [], 'per_video': []}
    peaks = {}
    for mode in ('per_video', 'packed', 'packed', 'per_video'):
        path, wall, cnt, peak = timed_run(cfgs[mode])
        check_detection_json(path, videos)
        walls[mode].append(wall)
        peaks[mode] = max(peaks.get(mode, 0.0), peak)
        if mode == 'packed':
            assert cnt[0] == POOLS_PER_FORWARD * forwards, cnt
    for mode, ws in walls.items():
        log(f'{mode}: warm runs in turns {[round(w, 3) for w in ws]} s, '
            f'{[round(n_windows / w, 2) for w in ws]} windows/s, peak '
            f'{peaks[mode]:.2f} GiB')
    share = busy_share(lambda: run_test(cfgs['packed']),
                       'packed run_test (warm)')
    parts = timed_parts(cfgs['packed'], 'packed run_test (warm)')
    return {'launches': launches, 'forwards': forwards,
            'windows': n_windows, 'share': share, 'parts': parts}


def phase_packed_f32(root, dirs, videos):
    log('== phase 17: packed vs per-video and host-staged vs device '
        'ingest, f32, TF32 off, on the first four packed videos '
        '(packed_batch 32, packed_frames 2048: windows of two videos in '
        'one forward, three flushes)')
    subset = list(videos.items())[:F32_SUBSET]
    forwards, _, flushes, _ = ingest_plan([v for _, v in subset], 2048,
                                          32)
    assert flushes == 3, flushes
    paths = {}
    with tf32_off():
        for mode, extra in (('packed', {}),
                            ('per_video', {'testing.packed': False}),
                            ('host_packed', {'testing.device_ingest': False}),
                            ('host_per_video', {
                                'testing.device_ingest': False,
                                'testing.packed': False})):
            cfg = load_config(CONFIG, overrides=dict(
                packed_overrides(root, dirs, 'subset_info.csv'), **extra, **{
                    'model.compute_dtype': 'float32',
                    'testing.packed_batch': 32,
                    'testing.packed_frames': 2048,
                    'testing.output_json': f'f32_{mode}.json'}))
            paths[mode], wall, cnt, _ = timed_run(cfg)
            check_detection_json(paths[mode], dict(subset))
            if mode == 'packed':
                assert cnt[0] == POOLS_PER_FORWARD * forwards, cnt
            log(f'{mode}: {wall:.3f} s, B1 launches {cnt[0]}')
    for mode in ('per_video', 'host_packed', 'host_per_video'):
        worst = assert_same_json(paths['packed'], paths[mode], mode)
        log(f'{mode} == packed device ingest per proposal (rtol 1e-4): '
            f'largest relative score difference {worst:.3g}')


def flow_state_dict(cfg):
    return factory.init_weights(factory.build_model(
        cfg, frame_num=FRAMES, crop_size=CROP, dtype=torch.float32,
        in_channels=2), seed=1).state_dict()


def build_flow_model(state_dict, dtype, stem_pallas=False) -> BDNet:
    m = BDNet(in_channels=2, num_classes=CLASSES, os_head=True,
              use_edl=True, evidence='exp', frame_num=FRAMES,
              crop_size=CROP, stem_pallas=stem_pallas,
              dtype=None if dtype == torch.float32 else dtype)
    m.load_state_dict(state_dict, strict=True)
    return m.to('cuda').eval()


def phase_fused_kernels(state_dict, flow_sd):
    """B1 on the pool inputs of one fused W=128 forward (both streams) and
    B4 at C = 2 (the flow stream's stem), each against its plain version
    exactly; B4 at C = 2 timed."""
    log('== phase 18: the kernels at the fused packed forward\'s shapes '
        '(W=128, bf16): B1 on both streams\' pool inputs, B4 at C = 2')
    g = torch.Generator(device='cuda').manual_seed(21)
    flow_u8 = torch.randint(0, 256, (PACKED_BATCH, 2, FRAMES, CROP, CROP),
                            generator=g, device='cuda', dtype=torch.uint8)
    flow_clips = (flow_u8.to(torch.bfloat16) / 255.0) * 2.0 - 1.0
    del flow_u8
    calls = capture_pool_inputs(build_flow_model(flow_sd, torch.bfloat16),
                                flow_clips)
    clips = random_clips(PACKED_BATCH, seed=22).to(torch.bfloat16)
    calls += capture_pool_inputs(build_model(state_dict, torch.bfloat16,
                                             'cuda'), clips)
    del clips
    torch.cuda.empty_cache()
    b1_err = 0.0
    for x, seg, levels in calls:
        got, _ = boundary_pool_cuda.boundary_max_pool_fwd(x, seg,
                                                          levels=levels)
        with boundary_pool.force_plain():
            want = boundary_pool.boundary_max_pool_segmented(x, seg, levels)
        b1_err = max(b1_err, (got.float() - want.float()).abs().max().item())
        if not torch.equal(got, want):
            raise AssertionError(f'B1 != plain at W=128: {tuple(x.shape)}')
    log(f'B1 == plain exactly on the {len(calls)} pool calls of a fused '
        f'W=128 forward (x {[tuple(c[0].shape) for c in calls]})')
    del calls
    torch.cuda.empty_cache()
    out = {}
    for w, dtype in ((PACKED_BATCH, torch.bfloat16), (32, torch.bfloat16),
                     (32, torch.float32)):
        xp = layers.space_to_depth_pad(flow_clips[:w].to(dtype),
                                       STEM_KERNEL)
        assert xp.shape[-1] == 2 and stem_pack_cuda.plan(xp, 1, 1) == \
            'frame_bulk'
        got = stem_pack_cuda.stem_pack96_v2(xp)
        want = stem_pack.stem_pack96_v2_plain(xp)
        err = (got.float() - want.float()).abs().max().item()
        if not torch.equal(got, want):
            raise AssertionError(f'B4 != plain at C = 2, W={w} {dtype}: '
                                 f'{err}')
        assert got.shape[2] == 64, got.shape
        del got, want
        if dtype == torch.bfloat16:
            r = {'ms': device_ms(lambda: stem_pack_cuda.stem_pack96_v2(xp),
                                 reps=10 if w > 32 else 20),
                 'plain_ms': device_ms(
                     lambda: stem_pack.stem_pack96_v2_plain(xp), reps=2),
                 'library_ms': device_ms(lambda: stem_pack.stem_pack_strided(
                     xp, layout='v2'), reps=5),
                 'bound_ms': pack_bound_ms(xp), 'max_abs_err': err}
            out[w] = r
            log(f'B4 C=2 W={w} bf16, xp {tuple(xp.shape)}: kernel '
                f'{r["ms"]:.4f} ms, plain {r["plain_ms"]:.4f}, library '
                f'{r["library_ms"]:.4f}, bound {r["bound_ms"]:.4f} '
                f'({r["bound_ms"] / r["ms"]:.3f} of it); {card_line()}')
        else:
            log(f'B4 == plain exactly at C = 2, W={w} f32')
        del xp
        torch.cuda.empty_cache()
    del flow_clips
    torch.cuda.empty_cache()
    return b1_err, out


def phase_fusion(root, dirs, videos):
    log(f'== phase 19: RGB + flow fusion, packed device ingest at full '
        f'width (run_test, bf16) with model.stem_pallas off and on; '
        f'{card_line()}')
    forwards, _, _, n_windows = ingest_plan(videos.values())
    res = {}
    for stem in (False, True):
        cfg = load_config(CONFIG, overrides=dict(
            packed_overrides(root, dirs), **{
                'testing.fusion': True, 'model.stem_pallas': stem,
                'testing.output_json': f'fused_{stem}.json'}))
        path, wall, cnt, peak = timed_run(cfg)
        n_props = check_detection_json(path, videos)
        assert cnt == (FUSED_POOLS * forwards, 0, 0,
                       2 * forwards if stem else 0), (cnt, forwards)
        res[stem] = {'counts': cnt, 'wall': wall, 'peak': peak}
        log(f'stem_pallas {stem}: {n_props} proposals; launches B1 {cnt[0]} '
            f'({FUSED_POOLS} per fused forward), B4 {cnt[3]}; first fused '
            f'run {wall:.3f} s ({n_windows / wall:.2f} windows/s), peak '
            f'{peak:.2f} GiB')
    return res


def phase_threshold(root, dirs, videos):
    log('== phase 20: threshold calibration (tools.threshold --fusion) '
        'over the packed videos as the training set')
    import yaml
    with open(CONFIG) as f:
        raw = yaml.safe_load(f)
    for dotted, value in dict(packed_overrides(root, dirs), **{
            'testing.output_path': os.path.join(root, 'out_threshold')
            }).items():
        cur = raw
        *parents, leaf = dotted.split('.')
        for p in parents:
            cur = cur.setdefault(p, {})
        cur[leaf] = value
    cfg_path = os.path.join(root, 'threshold.yaml')
    with open(cfg_path, 'w') as f:
        yaml.safe_dump(raw, f)
    forwards = ingest_plan(videos.values())[0]
    reset_counts()
    t0 = time.perf_counter()
    threshold_cli.main([cfg_path, '--fusion', '--output_json',
                        'thresholding.json'])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cnt = counts()
    with open(os.path.join(root, 'out_threshold', 'thresholding.json')) as f:
        payload = json.load(f)
    thr = payload['external_data']['threshold']
    assert set(payload['results']) == set(videos)
    assert math.isfinite(thr) and 0.0 <= thr <= 1.0, thr
    assert cnt == (FUSED_POOLS * forwards, 0, 0, 0), (cnt, forwards)
    log(f'threshold {thr} (confidence scoring, 95% TPR) over '
        f'{sum(len(v) for v in payload["results"].values())} proposals; '
        f'{wall:.3f} s; B1 launches {cnt[0]}')
    return thr, cnt[0]


# ------------------------------------------------------------- ActivityNet

ANET_CONFIG = 'configs/anet_opental.yaml'
ANET_FRAMES = 768
ANET_BATCH = 4                 # run_test_anet's video_batch (the default)
ANET_TRAIN_BS = 2              # the shipped config's batch_size
ANET_ROI = ((ANET_FRAMES, 189),)
ANET_LR_LEVELS = tuple((t, t) for t in (96, 48, 24, 12, 6, 3)) * 2
# 10 test videos: shorter than a clip (padded), one clip, longer (cut)
ANET_LENGTHS = (300, 520, 700, 768, 900, 1200, 450, 1000, 640, 820)
ANET_TRAIN_LENGTHS = (500, 800, 768, 650)
EXTREME_BOUNDS = (1e10, -1e10, math.inf, -math.inf, math.nan)


def anet_cfg(**overrides):
    return load_config(ANET_CONFIG, overrides=overrides)


def anet_model(state_dict, dtype, device):
    m = factory.build_model(anet_cfg(), frame_num=ANET_FRAMES,
                            crop_size=CROP, dtype=dtype)
    m.load_state_dict(state_dict, strict=True)
    return m.to(device).eval()


def anet_train_batch(b: int, seed: int, device):
    """`train_batch` at 768 frames with ANet's (action, start, end)
    heatmap rows, and the uint8 path's pad masks: the last 200 frames of
    sample 0 (and of its SSL clip) are padding."""
    batch = train_batch(b, ANET_FRAMES, CROP, seed, device)
    rng = np.random.RandomState(seed)
    batch['scores'] = torch.from_numpy(
        (rng.rand(b, 3, ANET_FRAMES) > 0.9).astype(np.float32)).to(device)
    pad = torch.zeros((b, ANET_FRAMES), dtype=torch.uint8, device=device)
    pad[0, -200:] = 1
    batch['pad_masks'] = pad
    batch['ssl_pad_masks'] = pad.clone()
    return batch


def extreme_levels(b: int, levels, seed: int) -> torch.Tensor:
    """`adversarial_levels` with about a third of the bounds replaced by
    +-1e10, +-inf and NaN (what stride-scaled offsets that overflowed
    would give)."""
    seg = adversarial_levels(b, levels, seed).cpu().numpy()
    rng = np.random.RandomState(seed)
    hit = rng.rand(*seg.shape) < 0.3
    seg[hit] = rng.choice(np.asarray(EXTREME_BOUNDS, np.float32),
                          int(hit.sum()))
    return torch.from_numpy(seg).cuda()


def phase_anet_kernels(state_dict):
    log('== phase 21: B1 and B2 at the ActivityNet shapes (W=4 bf16 '
        'forward, bs=2 f32 train step) vs plain version, exactly, on '
        'captured, adversarial and out-of-range (+-1e10, +-inf, NaN) '
        'windows')
    cfg = anet_cfg()
    calls = capture_pool_inputs(
        anet_model(state_dict, torch.bfloat16, 'cuda'),
        random_clips(ANET_BATCH, 31, ANET_FRAMES).to(torch.bfloat16))
    assert [c[2] for c in calls] == [ANET_ROI, ANET_LR_LEVELS], \
        [c[2] for c in calls]
    torch.cuda.empty_cache()
    model = train_model(cfg, ANET_FRAMES, CROP, 'cuda')
    train = capture_train_calls(model, cfg,
                                anet_train_batch(ANET_TRAIN_BS, 32, 'cuda'))
    del model
    torch.cuda.empty_cache()
    with_g = [c for c in train if c['g'] is not None]
    assert (len(train), len(with_g)) == (TRAIN_STEP_FWD, TRAIN_STEP_BWD), \
        (len(train), len(with_g))
    cases = [(x, seg, levels, None) for x, seg, levels in calls] + [
        (c['x'], c['seg'], c['levels'], c['g']) for c in with_g]
    max_err, bwd_err, n = 0.0, 0.0, 0
    for i, (x, seg, levels, g_cap) in enumerate(cases):
        b, t_len, c = x.shape
        gen = torch.Generator(device='cuda').manual_seed(40 + i)
        for dtype in (torch.float32, torch.bfloat16):
            xd = x.to(dtype).contiguous()
            for kind, segs in (
                    ('captured', seg),
                    ('adversarial', adversarial_levels(b, levels, 50 + i)),
                    ('extreme', extreme_levels(b, levels, 60 + i))):
                out, am = boundary_pool_cuda.boundary_max_pool_fwd(
                    xd, segs, True, levels)
                fast, _ = boundary_pool_cuda.boundary_max_pool_fwd(
                    xd, segs, levels=levels)
                want, want_am = boundary_pool.plain_forward_segmented(
                    xd, segs, levels, True)
                # g on a 1/64 grid: float sums of it are exact in any order
                g = (torch.randint(-256, 257, out.shape, generator=gen,
                                   device='cuda') / 64).to(dtype)
                dx = boundary_pool_cuda.boundary_max_pool_bwd(am, g, t_len,
                                                              levels)
                want_dx = boundary_pool.plain_backward_segmented(
                    want_am, g, levels)
                torch.cuda.synchronize()
                err = (fast.float() - want.float()).abs().max().item()
                max_err = max(max_err, err)
                tag = f'{kind} call {i} {tuple(x.shape)} {dtype}'
                if not (torch.equal(fast, want) and torch.equal(out, want)):
                    raise AssertionError(f'B1 != plain: {tag} err {err}')
                if not torch.equal(am.long(), want_am):
                    raise AssertionError(f'B1 argmax != plain: {tag}')
                if not torch.equal(dx, want_dx):
                    raise AssertionError(f'B2 != plain: {tag}')
                if g_cap is not None and kind == 'captured':
                    gd = g_cap.to(dtype).contiguous()
                    dx = boundary_pool_cuda.boundary_max_pool_bwd(
                        am, gd, t_len, levels)
                    want_dx = boundary_pool.plain_backward_segmented(
                        want_am, gd, levels)
                    bwd_err = max(bwd_err, (dx.float() - want_dx.float()
                                            ).abs().max().item())
                    torch.testing.assert_close(
                        dx, want_dx, rtol=1e-6, atol=1e-6,
                        msg=lambda m: f'B2 captured g {tag}: {m}')
                n += 1
    log(f'B1 (with and without argmax) and B2 == plain exactly on {n} '
        f'cases: the {len(calls)} pool calls of a W={ANET_BATCH} forward '
        f'and the {len(with_g)} of a bs={ANET_TRAIN_BS} train step x (f32, '
        f'bf16) x (captured, adversarial, out-of-range) windows, B2 on g on '
        f'a 1/64 grid; B2 on the captured g within rtol 1e-6 (max |diff| '
        f'{bwd_err}); B1 max_abs_err {max_err}')

    def plain_fwd():
        with boundary_pool.force_plain():
            for x, seg, levels in calls:
                boundary_pool.boundary_max_pool_segmented(x, seg, levels)

    fwd = {'ms': device_ms(lambda: [boundary_pool_cuda.boundary_max_pool_fwd(
        x, seg, levels=levels) for x, seg, levels in calls], reps=20),
        'plain_ms': device_ms(plain_fwd, reps=2),
        'bound_ms': sum(pool_bound_ms(*c) for c in calls)}
    grouped = []
    for c in with_g:
        _, am = boundary_pool_cuda.boundary_max_pool_fwd(
            c['x'], c['seg'], True, c['levels'])
        grouped.append((c['x'], c['levels'], c['g'], am))

    def plain_bwd():
        for x, levels, g, am in grouped:
            boundary_pool.plain_backward_segmented(am.long(), g, levels)

    def library():
        for x, _, g, am in grouped:
            torch.zeros((g.shape[0], x.shape[1], g.shape[2]), device='cuda'
                        ).scatter_add_(1, am.long(), g)

    bwd = {'ms': device_ms(lambda: [boundary_pool_cuda.boundary_max_pool_bwd(
        am, g, x.shape[1], levels) for x, levels, g, am in grouped],
        reps=20),
        'plain_ms': device_ms(plain_bwd, reps=1),
        'library_ms': device_ms(library, reps=20),
        'bound_ms': sum(bwd_bound_ms(g, x.shape[1])
                        for x, _, g, _ in grouped),
        'fwd_train_ms': device_ms(lambda: [
            boundary_pool_cuda.boundary_max_pool_fwd(c['x'], c['seg'], True,
                                                     c['levels'])
            for c in with_g], reps=20),
        'fwd_train_bound_ms': sum(pool_bound_ms(c['x'], c['seg'],
                                                c['levels'], True)
                                  for c in with_g)}
    for i, (x, seg, levels) in enumerate(calls):
        log(f'forward call {i}: x {tuple(x.shape)} {x.dtype}, K '
            f'{seg.shape[1]}, {len(levels)} levels; group bound '
            f'{pool_bound_ms(x, seg, levels):.6f} ms')
    log(f'ANet W={ANET_BATCH} bf16 forward, device ms: B1 grouped, '
        f'{len(calls)} calls: {fwd["ms"]}; plain {fwd["plain_ms"]}; group '
        f'bound {fwd["bound_ms"]} ({fwd["bound_ms"] / fwd["ms"]:.3f} of it); '
        f'{card_line()}')
    log(f'ANet bs={ANET_TRAIN_BS} f32 train step, device ms: B2 grouped, '
        f'{len(grouped)} calls: {bwd["ms"]}; plain {bwd["plain_ms"]}; '
        f'scatter_add_ {bwd["library_ms"]}; bound {bwd["bound_ms"]} '
        f'({bwd["bound_ms"] / bwd["ms"]:.3f} of it); B1 with argmax '
        f'{bwd["fwd_train_ms"]}, group bound {bwd["fwd_train_bound_ms"]}; '
        f'{card_line()}')
    del calls, train, with_g, grouped, cases
    torch.cuda.empty_cache()
    return max(max_err, bwd_err), fwd, bwd


def phase_anet_full_width(state_dict):
    log(f'== phase 22: the ActivityNet BDNet ({ANET_FRAMES} x {CROP} x '
        f'{CROP}, 151 classes) f32, TF32 off: card vs CPU at W=1, kernel '
        f'path vs plain path at W={ANET_BATCH}')
    with tf32_off():
        model = anet_model(state_dict, torch.float32, 'cuda')
        clips = random_clips(ANET_BATCH, 33, ANET_FRAMES)
        with torch.inference_mode():
            dev1 = model(clips[:1])
        cpu_model = anet_model(state_dict, torch.float32, 'cpu')
        t0 = time.perf_counter()
        with torch.inference_mode():
            ref1 = cpu_model(clips[:1].cpu())
        cpu_s = time.perf_counter() - t0
        del cpu_model
        for key in OUT_KEYS:
            got, want = dev1[key].float().cpu(), ref1[key].float()
            assert got.shape == want.shape, (key, got.shape, want.shape)
            assert torch.isfinite(got).all(), key
            torch.testing.assert_close(got, want, rtol=1e-3, atol=2e-3,
                                       msg=lambda m: f'{key}: {m}')
        n_priors = ANET_ROI[0][1]
        assert tuple(dev1['priors'].shape) == (n_priors, 2)
        log(f'card == CPU at W=1 (rtol 1e-3, atol 2e-3) on every out key; '
            f'priors ({n_priors}, 2); CPU forward {cpu_s:.1f} s')
        before = boundary_pool_cuda.LAUNCHES
        with torch.inference_mode():
            out_k = model(clips)
        launched = boundary_pool_cuda.LAUNCHES - before
        with torch.inference_mode(), boundary_pool.force_plain():
            out_p = model(clips)
        torch.cuda.synchronize()
        assert launched == POOLS_PER_FORWARD, launched
        for key in OUT_KEYS:
            if not torch.equal(out_k[key], out_p[key]):
                diff = (out_k[key] - out_p[key]).abs().max().item()
                raise AssertionError(f'kernel path != plain path on {key}: '
                                     f'{diff}')
        log(f'W={ANET_BATCH}: kernel path == plain path bit for bit on every '
            f'out key; {launched} B1 launches per forward')
        del model, clips, out_k, out_p


def phase_anet_train_step():
    log(f'== phase 23: one ActivityNet bs={ANET_TRAIN_BS} train step (f32, '
        f'TF32 off): kernel path vs plain path, dual-LR Adam; then its time')
    cfg = anet_cfg()
    batch = anet_train_batch(ANET_TRAIN_BS, 34, 'cuda')
    with tf32_off():
        model = train_model(cfg, ANET_FRAMES, CROP, 'cuda')
        f0, b0 = boundary_pool_cuda.LAUNCHES, boundary_pool_cuda.BWD_LAUNCHES
        terms_k, grads_k = loss_and_grads(model, cfg, batch)
        torch.cuda.synchronize()
        fwd = boundary_pool_cuda.LAUNCHES - f0
        bwd = boundary_pool_cuda.BWD_LAUNCHES - b0
        with boundary_pool.force_plain():
            terms_p, grads_p = loss_and_grads(model, cfg, batch)
            _, grads_p2 = loss_and_grads(model, cfg, batch)
        torch.cuda.synchronize()
        assert (fwd, bwd) == (TRAIN_STEP_FWD, TRAIN_STEP_BWD), (fwd, bwd)
        for k in terms_k:
            assert torch.isfinite(terms_k[k]), k
            if not torch.equal(terms_k[k], terms_p[k]):
                raise AssertionError(f'{k}: kernel path {terms_k[k]} != '
                                     f'plain path {terms_p[k]}')
        gn, gn_p = (global_norm(g.values()).item() for g in (grads_k,
                                                               grads_p))
        assert math.isfinite(gn) and math.isclose(gn, gn_p, rel_tol=1e-5), \
            (gn, gn_p)
        # PyTorch's max_pool3d backward adds with atomics, so even two
        # plain runs differ: each gradient may differ from the plain
        # path's by twice that run-to-run difference, plus 1e-5 of its max
        assert set(grads_k) == set(grads_p)
        worst = 0.0
        for name, gk in grads_k.items():
            gp = grads_p[name]
            noise = (gp - grads_p2[name]).abs().max().item()
            diff = (gk - gp).abs().max().item()
            allowed = 2 * noise + 1e-5 * gp.abs().max().item()
            assert diff <= allowed, (name, diff, noise, allowed)
            worst = max(worst, diff / allowed if allowed else 0.0)
        log(f'{fwd} B1 + {bwd} B2 launches per step; losses equal the plain '
            f'path\'s bit for bit; grad norm {gn:.6f} vs {gn_p:.6f} (rtol '
            f'1e-5); every gradient within twice the plain path\'s own '
            f'run-to-run difference + 1e-5 of its max (worst at '
            f'{worst:.3f} of that); cost {terms_k["cost"].item():.6f}')
        del grads_k, grads_p, grads_p2
    loss_cfg = factory.build_loss_config(cfg)
    opt = make_anet_optimizer(model, cfg.training['learning_rate'],
                              cfg.training['weight_decay'])
    heads, backbone = opt.param_groups
    assert math.isclose(backbone['lr'], 0.1 * heads['lr']), \
        (backbone['lr'], heads['lr'])
    n_backbone = sum(p.numel() for p in backbone['params'])
    assert n_backbone == sum(p.numel() for p in
                             model.backbone.parameters())
    state = TrainState(model=model, optimizer=opt,
                       edl_state=EDLState.create(loss_cfg.edl, 'cuda'))
    weights = factory.build_loss_weights(cfg)

    def step():
        train_step(state, loss_cfg, weights, batch, 11)

    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(5):
        step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / 5
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f'dual-LR Adam: heads lr {heads["lr"]}, backbone lr '
        f'{backbone["lr"]} ({n_backbone} backbone parameters); train step '
        f'bs={ANET_TRAIN_BS} f32 (TF32 on, PyTorch\'s default): {ms:.1f} ms, '
        f'{ANET_TRAIN_BS / ms * 1e3:.2f} clips/s, peak {peak:.2f} GiB; '
        f'{card_line()}')
    busy = profile_device(step, f'ANet train step bs={ANET_TRAIN_BS}')
    log(f'device busy {busy:.2f} ms of the {ms:.1f} ms step '
        f'({busy / ms:.1%})')
    del state, model, opt, batch
    torch.cuda.empty_cache()
    return {'ms': ms, 'peak': peak, 'busy': busy}


def write_anet_dataset(root: str, seed: int = 5):
    """The ANet set: ANET_LENGTHS validation and ANET_TRAIN_LENGTHS
    training uint8 videos at 112 x 112 (RGB, and 2-channel flow of the
    same length), fps 30, an ANet video-info JSON, 150 class names, video
    classifier files (validation; 3 of the 4 training videos) and a YAML
    of the shipped config pointing at all of it. Returns (config path,
    {name: duration} of the validation set, of the training subset in
    the classifier file, classifier file paths)."""
    g = torch.Generator().manual_seed(seed)
    dirs = {k: os.path.join(root, f'anet_{k}') for k in ('rgb', 'flow')}
    for d in dirs.values():
        os.makedirs(d)
    pools = {ch: torch.randint(0, 200, (1024, 112, 112, ch), generator=g,
                               dtype=torch.uint8) for ch in (2, 3)}
    info, durations = {}, {'validation': {}, 'training': {}}
    for subset, lengths in (('validation', ANET_LENGTHS),
                            ('training', ANET_TRAIN_LENGTHS)):
        for v, t in enumerate(lengths):
            name = f'v_{subset}_{v:03d}'
            for key, ch in (('rgb', 3), ('flow', 2)):
                x = pools[ch][torch.randint(0, 1024, (t,), generator=g)]
                s = int(torch.randint(0, t // 2, (1,), generator=g))
                x[s:s + t // 3] += 40       # a brighter action-like span
                np.save(os.path.join(dirs[key], name + '.npy'), x.numpy())
            info[name] = {'subset': subset, 'frame_num': t, 'fps': 30.0,
                          'duration': t / 30.0, 'annotations': [
                              {'label_id': 1 + v, 'label': f'Class{v:03d}',
                               'start_frame': s, 'end_frame': s + t // 3}]}
            durations[subset][name[2:]] = t / 30.0
    with open(os.path.join(root, 'anet_info.json'), 'w') as f:
        json.dump(info, f)
    classes = [f'Class{i:03d}' for i in range(150)]
    with open(os.path.join(root, 'anet_classes.txt'), 'w') as f:
        f.write('\n'.join(classes) + '\n')
    rng = np.random.RandomState(seed)
    cls_files = {}
    for subset, keys in (('validation', list(durations['validation'])),
                         ('training', list(durations['training'])[:3])):
        cls_files[subset] = os.path.join(root, f'anet_cls_{subset}.json')
        with open(cls_files[subset], 'w') as f:
            json.dump({'results': {k: rng.rand(150).tolist() for k in keys},
                       'class': classes}, f)
    import yaml
    with open(ANET_CONFIG) as f:
        raw = yaml.safe_load(f)
    info_path = os.path.join(root, 'anet_info.json')
    for dotted, value in {
            'dataset.class_info_path': os.path.join(root, 'anet_classes.txt'),
            'dataset.testing.video_info_path': info_path,
            'dataset.testing.video_mp4_path': dirs['rgb'],
            'dataset.testing.clip_length': ANET_FRAMES,
            'dataset.testing.crop_size': CROP,
            'dataset.training.video_info_path': info_path,
            'dataset.training.video_mp4_path': dirs['rgb'],
            'testing.checkpoint_path': os.path.join(root, 'anet.ckpt'),
            'testing.flow_checkpoint_path': os.path.join(root,
                                                         'anet_flow.ckpt'),
            'testing.flow_data_path': dirs['flow'],
            'testing.output_path': os.path.join(root, 'out_anet')}.items():
        cur = raw
        *parents, leaf = dotted.split('.')
        for p in parents:
            cur = cur.setdefault(p, {})
        cur[leaf] = value
    cfg_path = os.path.join(root, 'anet.yaml')
    with open(cfg_path, 'w') as f:
        yaml.safe_dump(raw, f)
    train_keys = {k: durations['training'][k]
                  for k in list(durations['training'])[:3]}
    return cfg_path, durations['validation'], train_keys, cls_files


def check_anet_json(path, durations) -> int:
    """An ANet detection JSON: every video (no 'v_' prefix), finite
    proposals inside [0, duration]; returns their number."""
    with open(path) as f:
        payload = json.load(f)
    assert payload['version'] == 'ActivityNet-v1.3'
    assert set(payload['results']) == set(durations), \
        sorted(payload['results'])
    n = 0
    for vid, props in payload['results'].items():
        for p in props:
            vals = [p['score'], p['uncertainty'], p['actionness'],
                    *p['segment']]
            assert all(math.isfinite(v) for v in vals), p
            assert 0.0 <= p['segment'][0] < p['segment'][1] <= \
                durations[vid] + 1e-9, (vid, p, durations[vid])
        n += len(props)
    assert n > 0, 'no proposals'
    return n


def anet_run(cfg_path, **kw):
    """run_test_anet on the ANet set from zeroed launch counts: (JSON path,
    wall s, counts, peak GiB)."""
    overrides = kw.pop('overrides', {})
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    path = test_anet.run_test_anet(load_config(cfg_path,
                                               overrides=overrides), **kw)
    torch.cuda.synchronize()
    return (path, time.perf_counter() - t0, counts(),
            torch.cuda.max_memory_allocated() / 2**30)


def phase_anet_inference(state_dict, root):
    forwards = -(-len(ANET_LENGTHS) // ANET_BATCH)
    log(f'== phase 24: ActivityNet inference end to end (run_test_anet, '
        f'bf16, video_batch {ANET_BATCH}) on {len(ANET_LENGTHS)} synthetic '
        f'videos ({forwards} forwards, a padded tail); {card_line()}')
    cfg_path, durations, train_keys, cls_files = write_anet_dataset(root)
    torch.save(state_dict, os.path.join(root, 'anet.ckpt'))
    flow = factory.init_weights(factory.build_model(
        anet_cfg(), frame_num=ANET_FRAMES, crop_size=CROP,
        dtype=torch.float32, in_channels=2), seed=6)
    torch.save(flow.state_dict(), os.path.join(root, 'anet_flow.ckpt'))
    del flow
    n_videos = len(ANET_LENGTHS)
    launches = 0
    path, wall, cnt, peak = anet_run(cfg_path, overrides={
        'testing.output_json': 'first.json'})
    n_props = check_anet_json(path, durations)
    assert cnt == (POOLS_PER_FORWARD * forwards, 0, 0, 0), (cnt, forwards)
    launches += cnt[0]
    log(f'first run: {n_props} proposals, {wall:.3f} s, '
        f'{n_videos / wall:.2f} videos/s, B1 {cnt[0]} launches '
        f'({POOLS_PER_FORWARD} x {forwards} forwards), peak {peak:.2f} GiB')
    walls = []
    for i in range(2):
        path, wall, cnt, peak_w = anet_run(cfg_path, overrides={
            'testing.output_json': f'warm{i}.json'})
        check_anet_json(path, durations)
        walls.append(wall)
    log(f'warm runs {[round(w, 3) for w in walls]} s, '
        f'{[round(n_videos / w, 2) for w in walls]} videos/s, peak '
        f'{peak_w:.2f} GiB')

    # the split: forward + decode of one batch of 4 (CUDA events), the
    # device post-processing of each batch (host clock from a sync)
    model = anet_model(state_dict, torch.bfloat16, 'cuda')
    clips = random_clips(ANET_BATCH, 35, ANET_FRAMES)
    cfg = anet_cfg()
    flags = factory.model_flags(cfg)

    def forward_decode():
        with torch.inference_mode():
            return test_anet.decode_windows(
                model(clips), ANET_FRAMES, use_edl=True, os_head=True,
                score_func='dirichlet', evidence=flags['evidence'])

    fwd_ms = time_ms(forward_decode, reps=5, warmup=2)
    del model, clips
    torch.cuda.empty_cache()
    post_s = []
    real_post = test_anet.build_device_post

    def timed_post(*a, **k):
        fn = real_post(*a, **k)

        def run(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args).cpu()
            post_s.append(time.perf_counter() - t0)
            return out
        return run

    test_anet.build_device_post = timed_post
    try:
        _, wall_p, _, _ = anet_run(cfg_path, overrides={
            'testing.output_json': 'timed.json'})
    finally:
        test_anet.build_device_post = real_post
    log(f'forward + decode of a batch of {ANET_BATCH} (bf16): {fwd_ms:.2f} '
        f'ms ({ANET_BATCH / fwd_ms * 1e3:.1f} videos/s); device '
        f'post-processing (150 classes x {ANET_BATCH} videos, batched '
        f'soft-NMS) {[round(s * 1e3, 1) for s in post_s]} ms per batch, '
        f'{sum(post_s):.3f} s of the {wall_p:.3f} s run '
        f'({sum(post_s) / wall_p:.1%}); {card_line()}')
    share = busy_share(lambda: test_anet.run_test_anet(load_config(
        cfg_path, overrides={'testing.output_json': 'busy.json'})),
        'run_test_anet (warm)')

    # device_nms true vs false per proposal, f32, deterministic cuDNN
    paths = {}
    with tf32_off():
        for dn in (True, False):
            paths[dn], wall, cnt, _ = anet_run(cfg_path, overrides={
                'model.compute_dtype': 'float32', 'testing.device_nms': dn,
                'testing.output_json': f'f32_device_nms_{dn}.json'})
            check_anet_json(paths[dn], durations)
            assert cnt[0] == POOLS_PER_FORWARD * forwards, cnt
            log(f'f32 device_nms {dn}: {wall:.3f} s')
    # the card's soft-NMS and the host's numpy loop round exp and the IoU
    # differently; a decayed score carries that through its later decays
    # and, where two scores sit within a rounding of each other, the pick
    # order can differ: so proposals are held at the tolerances of the CPU
    # parity tests' matcher across implementations
    # (tests/proposal_matching.py close(): score 2e-4 + 2e-3 x score,
    # segments 0.05 s)
    worst = assert_same_json(paths[True], paths[False], 'device_nms',
                             rtol=2e-3, atol=2e-4, seg_atol=0.05)
    log(f'device_nms true == false per proposal (score within 2e-4 + '
        f'2e-3 x score, segments 0.05 s): largest relative score '
        f'difference {worst:.3g}')

    path, wall, cnt, peak_f = anet_run(cfg_path, overrides={
        'testing.fusion': True, 'testing.output_json': 'fused.json'})
    n_fused = check_anet_json(path, durations)
    assert cnt == (2 * POOLS_PER_FORWARD * forwards, 0, 0, 0), cnt
    launches += cnt[0]
    log(f'fused RGB + flow: {n_fused} proposals, {wall:.3f} s, '
        f'{n_videos / wall:.2f} videos/s, B1 {cnt[0]}, peak {peak_f:.2f} GiB')

    reset_counts()
    t0 = time.perf_counter()
    test_anet.main([cfg_path, '--binary', '--cls_score_file',
                    cls_files['validation'], '--output_json',
                    'binary.json'])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cnt = counts()
    assert cnt == (POOLS_PER_FORWARD * forwards, 0, 0, 0), cnt
    launches += cnt[0]
    bin_path = os.path.join(root, 'out_anet', 'binary.json')
    n_bin = check_anet_json(bin_path, durations)
    with open(cls_files['validation']) as f:
        cls = json.load(f)
    with open(bin_path) as f:
        results = json.load(f)['results']
    for vid, props in results.items():
        label = cls['class'][int(np.argmax(cls['results'][vid]))]
        assert all(p['label'] == label for p in props), vid
    log(f'--binary with a classifier file (tools.test_anet CLI): {n_bin} '
        f'proposals, one class per video, {wall:.3f} s')

    reset_counts()
    t0 = time.perf_counter()
    threshold_cli.main([cfg_path, '--cls_score_file', cls_files['training'],
                        '--output_json', 'thresholding.json'])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cnt = counts()
    with open(os.path.join(root, 'out_anet', 'thresholding.json')) as f:
        payload = json.load(f)
    thr = payload['external_data']['threshold']
    assert set(payload['results']) == set(train_keys), payload['results']
    assert math.isfinite(thr) and 0.0 <= thr <= 1.0, thr
    assert cnt == (POOLS_PER_FORWARD, 0, 0, 0), cnt     # 3 videos, 1 batch
    launches += cnt[0]
    log(f'calibrate_anet (tools.threshold CLI, the 3 training videos of the '
        f'classifier file): threshold {thr}, '
        f'{sum(len(v) for v in payload["results"].values())} proposals, '
        f'{wall:.3f} s, B1 {cnt[0]}')
    return {'launches': launches, 'walls': walls, 'fwd_ms': fwd_ms,
            'post_s': post_s, 'share': share, 'threshold': thr}


def phase_anet_train_end_to_end(root):
    log('== phase 25: ActivityNet training end to end (tools.train, full '
        'width, 151 classes, synthetic videos): 2 epochs, checkpoint, '
        'resume, run_test_anet')
    data = os.path.join(root, 'anet_train_synth')
    cfg_path = make_synthetic_anet_dataset(
        data, n_train=4, n_val=1, clip_length=ANET_FRAMES, crop_size=CROP,
        spatial=112, num_known=150, seed=0)
    cfg = load_config(cfg_path, overrides={'training.max_epoch': 2,
                                           'training.uint8_ingest': True})
    assert cfg.get_path('model.arch') == 'anet'
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = train_loop(cfg, max_steps_per_epoch=2)
    heads, backbone = state.optimizer.param_groups
    assert math.isclose(backbone['lr'], 0.1 * heads['lr'])
    ckdir = cfg.training.checkpoint_path
    checkpoint.save(ckdir, SAVE_AFTER_EPOCH, state)
    train_cli.main([cfg_path, '--max_steps_per_epoch', '2', '--resume',
                    '-1', '--max_epoch', str(SAVE_AFTER_EPOCH + 1),
                    '--uint8_ingest'])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd, bwd = boundary_pool_cuda.LAUNCHES, boundary_pool_cuda.BWD_LAUNCHES
    assert pack_launches() == 0
    assert checkpoint.latest_epoch(ckdir) == SAVE_AFTER_EPOCH + 1
    payload = torch.load(checkpoint.epoch_path(ckdir, SAVE_AFTER_EPOCH + 1),
                         map_location='cpu', weights_only=True)
    steps = payload['step']
    assert len(payload['optimizer']['param_groups']) == 2
    assert state.step >= 2 and steps > state.step, (state.step, steps)
    with open(os.path.join(ckdir, 'metrics.jsonl')) as f:
        recs = [json.loads(line) for line in f]
    assert [r['step'] for r in recs] == list(range(1, steps + 1))
    for r in recs:
        assert all(math.isfinite(v) for v in r.values()), r
    assert (fwd, bwd) == (TRAIN_STEP_FWD * steps, TRAIN_STEP_BWD * steps), \
        (fwd, bwd)
    log(f'{steps} steps over epochs 1, 2 and (resumed) 11 in {wall:.1f} s '
        f'(data and checkpoints included); costs '
        f'{[round(r["cost"], 4) for r in recs]}; launches B1 {fwd}, B2 {bwd} '
        f'({TRAIN_STEP_FWD} and {TRAIN_STEP_BWD} per step)')
    with open(os.path.join(data, 'annotations', 'video_info.json')) as f:
        info = json.load(f)
    durations = {k[2:]: v['duration'] for k, v in info.items()
                 if v['subset'] == 'validation'}
    path = test_anet.run_test_anet(load_config(cfg_path))
    n = check_anet_json(path, durations)
    log(f'run_test_anet on the trained checkpoint: {n} proposals, finite')
    return fwd, bwd


# ------------------------------------------- the open-set slice (26 - 29)

SPAN_GROUP = InferencePipeline.shared_group    # windows per span
SPAN = 128 * (SPAN_GROUP - 1) + FRAMES + 8
SPAN_CHUNK = InferencePipeline.shared_max_groups


def shared_plan(videos, capacity: int = PACKED_FRAMES) -> dict:
    """Forwards of the shared-backbone runs over videos [(frames,
    sample_count)], by the span scheduler's rule restated: per video one
    forward per SPAN_CHUNK spans; packed, a video opens a new flush where
    its region (from the next multiple of 8: its last span's end or its
    frame count, whichever is larger) would overflow the capacity, and a
    flush runs one forward per SPAN_CHUNK of its spans."""
    packed = per_video = windows = spans = flush = cursor = 0
    for t, count in videos:
        offsets = pipeline_mod.snapped_offsets(count, FRAMES, 128)
        bases, _, _ = pipeline_mod.span_plan(offsets, SPAN_GROUP)
        need = max(int(bases[-1]) + SPAN, t)
        start = -(-cursor // 8) * 8
        if flush and start + need > capacity:
            packed += -(-flush // SPAN_CHUNK)
            flush, start = 0, 0
        flush += len(bases)
        cursor = start + need
        per_video += -(-len(bases) // SPAN_CHUNK)
        windows += len(offsets)
        spans += len(bases)
    packed += -(-flush // SPAN_CHUNK)
    return {'packed': packed, 'per_video': per_video, 'windows': windows,
            'spans': spans}


def capture_calls(fn):
    """(x, segments, levels) of every boundary-pool call of fn()."""
    calls = []
    real = pyramid.boundary_max_pool_segmented

    def recording(x, seg, levels):
        calls.append((x.clone(), seg.clone(), levels))
        return real(x, seg, levels)

    pyramid.boundary_max_pool_segmented = recording
    try:
        fn()
    finally:
        pyramid.boundary_max_pool_segmented = real
    return calls


def hold_b1(calls, label: str) -> float:
    """B1 == its plain version exactly on captured calls (in f32 and
    bf16); returns the largest |diff| (0)."""
    err = 0.0
    for i, (x, seg, levels) in enumerate(calls):
        for dtype in (torch.float32, torch.bfloat16):
            xd = x.to(dtype).contiguous()
            got, _ = boundary_pool_cuda.boundary_max_pool_fwd(
                xd, seg, levels=levels)
            with boundary_pool.force_plain():
                want = boundary_pool.boundary_max_pool_segmented(
                    xd, seg, levels)
            err = max(err, (got.float() - want.float()).abs().max().item())
            if not torch.equal(got, want):
                raise AssertionError(f'B1 != plain on {label} call {i} '
                                     f'{tuple(x.shape)} {dtype}')
    return err


def span_clips(n: int, seed: int) -> torch.Tensor:
    """(n, SPAN, CROP, CROP, 3) uint8 frames made on the card."""
    g = torch.Generator(device='cuda').manual_seed(seed)
    return torch.randint(0, 256, (n, SPAN, CROP, CROP, 3), generator=g,
                         device='cuda', dtype=torch.uint8)


def phase_shared_kernels(state_dict):
    """B1 at the shared forward's shapes and B4 at the span shape."""
    pipe = InferencePipeline(build_model(state_dict, torch.bfloat16,
                                         'cuda'), clip_length=FRAMES,
                             crop_size=CROP, shared_backbone=True,
                             use_edl=True, os_head=True, device='cuda')
    n = SPAN_CHUNK
    frames = span_clips(1, 5)[0]
    buf = torch.cat([frames] * 2 + [frames[:8]])       # 2 spans + 8
    bases = torch.arange(n, device='cuda') % 9         # spans at 0 .. 8
    local = torch.tensor([0, 128, 256, 384], device='cuda').repeat(n, 1)
    calls = capture_calls(lambda: pipe.span_decode([buf], bases, local,
                                                   2 * SPAN + 8))
    assert len(calls) == POOLS_PER_FORWARD, len(calls)
    err = hold_b1(calls, 'the shared forward')

    def grouped():
        for x, seg, levels in calls:
            boundary_pool_cuda.boundary_max_pool_fwd(x, seg, levels=levels)

    def plain():
        with boundary_pool.force_plain():
            for x, seg, levels in calls:
                boundary_pool.boundary_max_pool_segmented(x, seg, levels)

    b1 = {'ms': device_ms(grouped, reps=20),
          'plain_ms': device_ms(plain, reps=3),
          'bound_ms': sum(pool_bound_ms(*c) for c in calls)}
    log(f'B1 == plain exactly on the {len(calls)} pool calls of one shared '
        f'forward ({n} spans, {n * SPAN_GROUP} windows: x '
        f'{[tuple(c[0].shape) for c in calls]}), f32 and bf16; per forward '
        f'{b1["ms"]:.4f} ms (plain {b1["plain_ms"]:.4f}, group bound '
        f'{b1["bound_ms"]:.6f}, {b1["bound_ms"] / b1["ms"]:.3f} of it); '
        f'{card_line()}')
    del pipe, calls, buf
    torch.cuda.empty_cache()

    # B4 (stem_pack96_v2) at the span shape: the shared path with
    # model.stem_pallas packs (spans, SPAN) frames, t_out SPAN / 2
    x = span_clips(16, 6).permute(0, 4, 1, 2, 3).to(torch.bfloat16)
    xp = layers.space_to_depth_pad(x, STEM_KERNEL)
    del x
    kernel, plain_pack, kw = PACKS['v2 fp=1']
    got, want = kernel(xp, **kw), plain_pack(xp, **kw)
    if not torch.equal(got, want):
        raise AssertionError('B4 != plain at the span shape')
    b4 = {'ms': device_ms(lambda: kernel(xp, **kw), reps=10),
          'plain_ms': device_ms(lambda: plain_pack(xp, **kw), reps=3),
          'library_ms': device_ms(lambda: stem_pack.stem_pack_strided(
              xp, layout='v2', **kw), reps=5),
          'bound_ms': pack_bound_ms(xp)}
    log(f'B4 at the span shape: xp {tuple(xp.shape)} bf16 (t_out '
        f'{got.shape[1]}), kernel == plain exactly; {b4["ms"]:.4f} ms '
        f'(plain {b4["plain_ms"]:.4f}, strided copy '
        f'{b4["library_ms"]:.4f}, bound {b4["bound_ms"]:.4f}, '
        f'{b4["bound_ms"] / b4["ms"]:.3f} of it); {card_line()}')
    del xp, got, want
    torch.cuda.empty_cache()
    return err, b1, b4


def phase_shared_f32(state_dict):
    """Interior alignment and card == CPU for the shared path, f32."""
    with tf32_off(), torch.inference_mode():
        model = build_model(state_dict, torch.float32, 'cuda')
        u8 = span_clips(1, 7)[0]
        x = pipeline_mod.device_windows(u8, torch.zeros(
            1, dtype=torch.long, device='cuda'), SPAN, SPAN)
        # the second window of the span; interior steps: those at least
        # 56 frames (the receptive field's reach) from the window's edges
        off = 128
        full = model.backbone_features(x)
        win = model.backbone_features(x[:, :, off:off + FRAMES].contiguous())
        worst = 0.0
        inner = {s: slice(56 // s, FRAMES // s - 56 // s) for s in (4, 8)}
        for key, s in (('Mixed_4f', 4), ('Mixed_5c', 8)):
            inner_s = inner[s]
            shared = full[key][:, :, off // s:off // s + FRAMES // s]
            torch.testing.assert_close(shared[:, :, inner_s],
                                       win[key][:, :, inner_s], atol=2e-5,
                                       rtol=1e-5, msg=lambda m: f'{key}: {m}')
            worst = max(worst, (shared[:, :, inner_s]
                                - win[key][:, :, inner_s]).abs().max().item())
            edge = (shared[:, :, 0] - win[key][:, :, 0]).abs().max().item()
            assert edge > 1e-4, (key, edge)
        log(f'f32: a window\'s Mixed_4f steps [{inner[4].start}, '
            f'{inner[4].stop}) and Mixed_5c steps [{inner[8].start}, '
            f'{inner[8].stop}) sliced from a {SPAN}-frame span equal the '
            f'per-window '
            f'backbone\'s (atol 2e-5, rtol 1e-5; worst |diff| {worst:.3g}); '
            f'the edge steps differ (real context vs zero padding)')

        # card == CPU on one short video: one span, 2 windows
        rng = np.random.RandomState(8)
        video = rng.randint(0, 256, (300, 100, 100, 3), dtype=np.uint8)
        decs = {}
        for dev in ('cuda', 'cpu'):
            pipe = InferencePipeline(build_model(state_dict, torch.float32,
                                                 dev), clip_length=FRAMES,
                                     crop_size=CROP, shared_backbone=True,
                                     use_edl=True, os_head=True, device=dev)
            offsets = pipeline_mod.snapped_offsets(300, FRAMES, 128)
            bases, local, _ = pipeline_mod.span_plan(offsets, SPAN_GROUP)
            buf = pipeline_mod.stage_frames(
                pipeline_mod.transforms.center_crop(video, CROP),
                pad_to=int(bases[-1]) + SPAN, device=dev)
            t0 = time.perf_counter()
            decs[dev] = pipe.span_decode([buf], torch.from_numpy(bases).to(
                dev), torch.from_numpy(local).to(dev), 300)
            if dev == 'cpu':
                cpu_s = time.perf_counter() - t0
        for field in ('segments', 'scores', 'uncertainty', 'actionness'):
            got = getattr(decs['cuda'], field).float().cpu()
            torch.testing.assert_close(got, getattr(decs['cpu'], field),
                                       rtol=1e-3, atol=2e-3,
                                       msg=lambda m: f'{field}: {m}')
        log(f'card == CPU on the shared decode of a 300-frame video '
            f'({len(offsets)} windows, 1 span; rtol 1e-3, atol 2e-3), f32; '
            f'CPU {cpu_s:.1f} s')
    del model, pipe, decs
    torch.cuda.empty_cache()


def phase_shared(root, dirs, videos, state_dict):
    log(f'== phase 26: shared-backbone inference (testing.shared_backbone: '
        f'{SPAN_GROUP}-window spans of {SPAN} frames, up to {SPAN_CHUNK} '
        f'spans per forward) at full width on the packed videos, per video '
        f'and packed, in turns with the default packed path (bf16); '
        f'{card_line()}')
    plan = shared_plan([(t, c) for t, c, _ in videos.values()])
    base = packed_overrides(root, dirs)
    cfgs = {mode: load_config(CONFIG, overrides=dict(base, **extra, **{
        'testing.output_json': f'{mode}.json'}))
        for mode, extra in (
            ('shared', {'testing.shared_backbone': True}),
            ('shared_per_video', {'testing.shared_backbone': True,
                                  'testing.packed': False}),
            ('default', {}))}
    path, wall, cnt, peak = timed_run(cfgs['shared'])
    n_props = check_detection_json(path, videos)
    assert cnt == (POOLS_PER_FORWARD * plan['packed'], 0, 0, 0), (cnt, plan)
    launches = cnt[0]
    n = plan['windows']
    log(f'{n} windows in {plan["spans"]} spans, {plan["packed"]} forwards '
        f'packed ({plan["per_video"]} per video); B1 launches {cnt[0]} '
        f'({POOLS_PER_FORWARD} per forward); {n_props} proposals; first '
        f'run {wall:.3f} s, {n / wall:.2f} windows/s, peak {peak:.2f} GiB')
    path, wall, cnt, peak = timed_run(cfgs['shared_per_video'])
    check_detection_json(path, videos)
    assert cnt[0] == POOLS_PER_FORWARD * plan['per_video'], (cnt, plan)
    launches += cnt[0]
    log(f'per video (testing.packed: false): {wall:.3f} s, '
        f'{n / wall:.2f} windows/s, B1 launches {cnt[0]}, peak '
        f'{peak:.2f} GiB')
    walls, peaks = {'default': [], 'shared': []}, {}
    for mode in ('default', 'shared', 'shared', 'default'):
        path, wall, cnt, peak = timed_run(cfgs[mode])
        walls[mode].append(wall)
        peaks[mode] = max(peaks.get(mode, 0.0), peak)
        if mode == 'shared':
            assert cnt[0] == POOLS_PER_FORWARD * plan['packed'], cnt
    for mode, ws in walls.items():
        log(f'{mode} packed: warm runs in turns {[round(w, 3) for w in ws]}'
            f' s, {[round(n / w, 2) for w in ws]} windows/s, peak '
            f'{peaks[mode]:.2f} GiB')
    share = busy_share(lambda: run_test(cfgs['shared']),
                       'shared packed run_test (warm)')
    err, b1, b4 = phase_shared_kernels(state_dict)
    phase_shared_f32(state_dict)
    # model.stem_pallas on the spans: B4 packs every span, on 4 videos
    subset = list(videos.items())[:F32_SUBSET]
    sub_plan = shared_plan([(t, c) for _, (t, c, _) in subset])
    path, wall, cnt, _ = timed_run(load_config(CONFIG, overrides=dict(
        packed_overrides(root, dirs, 'subset_info.csv'), **STEM_CFG, **{
            'testing.shared_backbone': True,
            'testing.output_json': 'shared_stem.json'})))
    check_detection_json(path, dict(subset))
    assert cnt == (POOLS_PER_FORWARD * sub_plan['packed'], 0, 0,
                   sub_plan['packed']), (cnt, sub_plan)
    log(f'model.stem_pallas on spans (4 videos): {wall:.3f} s, B1 '
        f'{cnt[0]}, B4 {cnt[3]} launches (1 per forward)')
    return {'launches': launches, 'err': err, 'b1': b1, 'b4': b4,
            'b4_launches': cnt[3], 'stem_b1': cnt[0], 'share': share,
            'walls': walls}


def rpl_cfg(name: str):
    return load_config(f'configs/thumos14_open_{name}.yaml')


def rpl_terms_and_grads(model, cfg, batch, edl=None):
    """Loss terms and parameter gradients of one RPL / GCPL step."""
    model.train()
    model.zero_grad(set_to_none=True)
    cost, terms, _ = compute_losses(model, factory.build_loss_config(cfg),
                                    factory.build_loss_weights(cfg),
                                    device_ingest(batch), edl, 1)
    cost.backward()
    return ({k: v.detach() for k, v in terms.items()},
            {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None})


def phase_rpl(train_cfg_path):
    log('== phase 27: the RPL and GCPL baselines (configs/thumos14_open_'
        '{rpl,gcpl}.yaml): a bs=1 f32 step, TF32 off, kernel path vs plain '
        'path and card vs CPU; step time against the OpenTAL step; '
        'tools.train for 2 steps with a checkpoint, then run_test')
    out = {'fwd': 0, 'bwd': 0, 'infer': 0}
    with tf32_off():
        batch = train_batch(1, FRAMES, CROP, 12, 'cuda')
        for name in ('rpl', 'gcpl'):
            cfg = rpl_cfg(name)
            model = train_model(cfg, FRAMES, CROP, 'cuda')
            f0, b0 = boundary_pool_cuda.LAUNCHES, \
                boundary_pool_cuda.BWD_LAUNCHES
            terms_k, grads_k = rpl_terms_and_grads(model, cfg, batch)
            torch.cuda.synchronize()
            launched = (boundary_pool_cuda.LAUNCHES - f0,
                        boundary_pool_cuda.BWD_LAUNCHES - b0)
            assert launched == (TRAIN_STEP_FWD, TRAIN_STEP_BWD), launched
            with boundary_pool.force_plain():
                terms_p, grads_p = rpl_terms_and_grads(model, cfg, batch)
            for k in terms_k:
                assert torch.equal(terms_k[k], terms_p[k]), (name, k)
            worst = 0.0
            for n_, gk in grads_k.items():
                scale = grads_p[n_].abs().max().item()
                torch.testing.assert_close(gk, grads_p[n_], rtol=1e-5,
                                           atol=1e-5 * scale,
                                           msg=lambda m: f'{name} {n_}: {m}')
                if scale > 0:
                    worst = max(worst, (gk - grads_p[n_]).abs().max().item()
                                / scale)
            radius = 'coarse_pyramid_detection.rpl_radius'
            assert (radius in grads_k) == (name == 'rpl'), name
            cpu_model = train_model(cfg, FRAMES, CROP, 'cpu')
            terms_c, grads_c = rpl_terms_and_grads(
                cpu_model, cfg, {k: v.cpu() for k, v in batch.items()})
            for k in terms_c:
                torch.testing.assert_close(terms_k[k].cpu(), terms_c[k],
                                           rtol=1e-3, atol=2e-3,
                                           msg=lambda m: f'{name} {k}: {m}')
            gn_d = global_norm(grads_k.values()).item()
            gn_c = global_norm(grads_c.values()).item()
            torch.testing.assert_close(torch.tensor(gn_d),
                                       torch.tensor(gn_c), rtol=1e-3,
                                       atol=2e-3)
            log(f'{name}: {launched[0]} B1 + {launched[1]} B2 launches; '
                f'losses equal the plain path\'s bit for bit, gradients '
                f'within rtol 1e-5 (worst |diff| / max {worst:.3g}); card == '
                f'CPU (rtol 1e-3, atol 2e-3): cost '
                f'{terms_k["cost"].item():.6f} vs '
                f'{terms_c["cost"].item():.6f}, loss_c '
                f'{terms_k["loss_c"].item():.6f}, grad norm {gn_d:.6f} vs '
                f'{gn_c:.6f}')
            del model, cpu_model, grads_k, grads_p, grads_c
        torch.cuda.empty_cache()

    # step time (PyTorch's defaults, as phase 8): OpenTAL, RPL, GCPL in
    # turns, bs=1
    states, cfgs = {}, {'opental': load_config(CONFIG),
                        'rpl': rpl_cfg('rpl'), 'gcpl': rpl_cfg('gcpl')}
    for name, cfg in cfgs.items():
        model = train_model(cfg, FRAMES, CROP, 'cuda')
        edl = factory.build_loss_config(cfg).edl
        states[name] = TrainState(
            model=model, optimizer=make_optimizer(model, 1e-5, 1e-3),
            edl_state=None if edl is None else EDLState.create(edl, 'cuda'))
    batch = train_batch(1, FRAMES, CROP, 5, 'cuda')

    def step(name):
        cfg = cfgs[name]
        train_step(states[name], factory.build_loss_config(cfg),
                   factory.build_loss_weights(cfg), batch, 11)

    for name in cfgs:
        step(name)
    ms, mem = {n: 0.0 for n in cfgs}, {n: 0.0 for n in cfgs}
    order = list(cfgs) + list(cfgs)[::-1]
    for name in order:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(5):
            step(name)
        torch.cuda.synchronize()
        ms[name] += (time.perf_counter() - t0) * 1e3 / 5 / 2
        mem[name] = max(mem[name], torch.cuda.max_memory_allocated() / 2**30)
    log(f'bs=1 step (f32, TF32 as default), in turns: ' + ', '.join(
        f'{n} {ms[n]:.1f} ms' for n in cfgs) + '; peak (the three states '
        f'resident) ' + ', '.join(f'{n} {mem[n]:.2f} GiB' for n in cfgs)
        + f'; {card_line()}')
    out['ms'], out['peak'] = ms, mem
    del states, batch
    torch.cuda.empty_cache()

    # tools.train: 2 steps from a checkpoint of the seeded start, saved as
    # epoch 10; the CLI resumes it for epoch 11, which saves itself; then
    # run_test on the result
    with open(train_cfg_path) as f:
        data = yaml.safe_load(f)
    for name in ('rpl', 'gcpl'):
        base = rpl_cfg(name)
        cfg_data = copy.deepcopy(data)
        cfg_data['model'] = dict(base.get_path('model'))
        cfg_data['model']['backbone_model'] = ''
        tr = cfg_data['training']
        for key in ('edl_loss', 'edl_config', 'act_config'):
            tr.pop(key, None)
        tr.update(rpl_loss=True, rpl_config=dict(base.get_path(
            'training.rpl_config')), focal_loss=False)
        ckdir = os.path.join(os.path.dirname(train_cfg_path), f'ck_{name}')
        tr['checkpoint_path'] = ckdir
        cfg_data['testing']['checkpoint_path'] = os.path.join(
            ckdir, 'checkpoint-latest.ckpt')
        cfg_data['testing']['output_json'] = f'{name}.json'
        path = os.path.join(os.path.dirname(train_cfg_path),
                            f'{name}.yaml')
        with open(path, 'w') as f:
            yaml.safe_dump(cfg_data, f)
        cfg = load_config(path)
        state = train_init_state(cfg, torch.device('cuda'), 0, FRAMES, CROP)
        checkpoint.save(ckdir, SAVE_AFTER_EPOCH, state)
        del state
        reset_counts()
        t0 = time.perf_counter()
        train_cli.main([path, '--max_steps_per_epoch', '2', '--resume',
                        '-1', '--max_epoch', str(SAVE_AFTER_EPOCH + 1)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        fwd, bwd = boundary_pool_cuda.LAUNCHES, \
            boundary_pool_cuda.BWD_LAUNCHES
        assert (fwd, bwd) == (2 * TRAIN_STEP_FWD, 2 * TRAIN_STEP_BWD), \
            (fwd, bwd)
        payload = torch.load(checkpoint.epoch_path(ckdir,
                                                   SAVE_AFTER_EPOCH + 1),
                             map_location='cpu', weights_only=True)
        radius = payload['model']['coarse_pyramid_detection.rpl_radius']
        with open(os.path.join(ckdir, 'metrics.jsonl')) as f:
            recs = [json.loads(line) for line in f]
        assert len(recs) == 2 and all(
            math.isfinite(v) for r in recs for v in r.values()), recs
        out['fwd'] += fwd
        out['bwd'] += bwd
        reset_counts()
        cfg = load_config(path)
        pipe, _, _ = build_pipeline(cfg)
        assert pipe.use_gcpl == (name == 'gcpl')
        del pipe
        json_path = run_test(cfg)
        with open(json_path) as f:
            results = json.load(f)['results']
        n_props = sum(len(v) for v in results.values())
        assert n_props > 0 and all(
            math.isfinite(v) for props in results.values() for p in props
            for v in [p['score'], *p['segment']]), n_props
        out['infer'] += boundary_pool_cuda.LAUNCHES
        scores = 'negated distances' if name == 'gcpl' else 'distances'
        log(f'{name}: tools.train 2 steps in {wall:.1f} s (costs '
            f'{[round(r["cost"], 4) for r in recs]}, radius '
            f'{radius.item():.6f}), B1 {fwd} + B2 {bwd} launches; run_test '
            f'on the checkpoint ({scores}): {n_props} proposals, B1 '
            f'{boundary_pool_cuda.LAUNCHES}')
    return out


def openmax_config(root):
    """configs/thumos14_openmax.yaml on a synthetic dataset of its 15
    known classes (2 training and 2 test videos at 112 x 112), with
    seeded closed-set weights; returns (YAML path, loaded config)."""
    data = os.path.join(root, 'openmax_synth')
    synth_path = make_synthetic_dataset(data, n_train=2, n_test=2,
                                        clip_length=FRAMES, crop_size=CROP,
                                        spatial=112, num_known=15, seed=3,
                                        temporal_ramp=True)
    with open(synth_path) as f:
        synth = yaml.safe_load(f)
    with open('configs/thumos14_openmax.yaml') as f:
        raw = yaml.safe_load(f)
    raw['dataset'] = synth['dataset']
    raw['model']['backbone_model'] = ''
    ckpt = os.path.join(data, 'softmax.ckpt')
    raw['testing'].update(checkpoint_path=ckpt,
                          output_path=os.path.join(data, 'out'))
    path = os.path.join(data, 'openmax.yaml')
    with open(path, 'w') as f:
        yaml.safe_dump(raw, f)
    cfg = load_config(path)
    model = factory.init_weights(factory.build_model(
        cfg, frame_num=FRAMES, crop_size=CROP), seed=9)
    torch.save(model.state_dict(), ckpt)
    return path, cfg


def phase_openmax(root):
    log('== phase 28: OpenMax (configs/thumos14_openmax.yaml: softmax '
        'heads, no os_head, no EDL) on synthetic videos of its 15 classes: '
        'stage 1 (MAVs of the get_feat taps, kernel path == plain path), '
        'stage 2 (Weibull fit), stage 3 (recalibrated test), the CLI, '
        'eval_open')
    path, cfg = openmax_config(root)
    out_dir = cfg.testing['output_path']
    mav = {'kernel': os.path.join(out_dir, 'mav_dist'),
           'plain': os.path.join(out_dir, 'mav_dist_plain')}
    t = {}
    with tf32_off():
        reset_counts()
        t0 = time.perf_counter()
        test_openmax.compute_mav_dist(cfg, mav['kernel'])
        torch.cuda.synchronize()
        t['stage 1'] = time.perf_counter() - t0
        stage1 = boundary_pool_cuda.LAUNCHES
        with boundary_pool.force_plain():
            test_openmax.compute_mav_dist(cfg, mav['plain'])
    names = sorted(os.listdir(mav['kernel']))
    assert names == sorted(os.listdir(mav['plain'])) and len(names) == 15
    n_feats = 0
    for fn in names:
        a = np.load(os.path.join(mav['kernel'], fn))
        b = np.load(os.path.join(mav['plain'], fn))
        for k in b.files:
            assert np.array_equal(a[k], b[k]), (fn, k)
        n_feats += len(a['dist']) + len(a['dist_prop'])
    _, idx_to_class = get_class_index_map(
        cfg.get_path('dataset.class_info_path'))
    class_names = [idx_to_class[i] for i in sorted(idx_to_class)]
    t0 = time.perf_counter()
    wm, wpm = weibull_fitting(mav['kernel'], class_names)
    t['stage 2'] = time.perf_counter() - t0
    fitted = sum(m['model'][0] is not None for m in wm.values())
    reset_counts()
    t0 = time.perf_counter()
    json_path = test_openmax.run_openmax_test(cfg, mav['kernel'])
    torch.cuda.synchronize()
    t['stage 3'] = time.perf_counter() - t0
    stage3 = boundary_pool_cuda.LAUNCHES
    with open(cfg.get_path('dataset.testing.video_info_path')) as f:
        lengths = {ln.split(',')[0]: int(ln.split(',')[4])
                   for ln in f.read().splitlines()[1:]}
    n_props = check_detection_json(json_path, lengths)
    forwards = sum(-(-len(window_offsets(c, FRAMES, 128))
                     // test_openmax.MAX_BATCH) for c in lengths.values())
    assert stage3 == POOLS_PER_FORWARD * forwards, (stage3, forwards)
    first = json_path + '.first'
    shutil.copy(json_path, first)
    test_openmax.main([path])        # stages 2 and 3; the MAVs are read
    worst = assert_same_json(first, json_path, 'OpenMax CLI')
    anno = os.path.dirname(cfg.get_path('dataset.class_info_path'))
    eval_open.main([json_path, os.path.join(anno, 'gt_open.json'),
                    '--cls_idx_known',
                    cfg.get_path('dataset.class_info_path'), '--open_set'])
    with open(os.path.join(out_dir, 'eval_open.txt')) as f:
        avg = f.read().strip().splitlines()[-1]
    vals = [float(v.split(':')[1]) for v in avg.split(', ')]
    assert len(vals) == 4 and all(math.isfinite(v) for v in vals), avg
    log(f'stage 1: {n_feats} positive features over the training clips, '
        f'15 MAV files equal to the plain path\'s exactly, B1 {stage1}; '
        f'stage 2: {fitted} of 15 classes fitted; stage 3: {len(lengths)} '
        f'videos, {n_props} proposals, B1 {stage3} ({forwards} forwards); '
        f'times ' + ', '.join(f'{k} {v:.3f} s' for k, v in t.items())
        + f'; the CLI again (MAVs read back) equal per proposal (worst '
        f'{worst:.3g}); eval_open --open_set: {avg}; {card_line()}')
    return {'launches': stage1 + stage3, 'times': t}


def write_yaml(cfg, path):
    with open(path, 'w') as f:
        yaml.safe_dump(json.loads(json.dumps(cfg)), f)
    return path


def phase_cross_search(root, lengths):
    log('== phase 29: cross-data (tools.test_cross_data: the THUMOS test '
        'videos of phase 6 and synthetic ActivityNet videos) and '
        'tools.search_param over a 2 x 2 grid, its cache re-read')
    anet_root = os.path.join(root, 'anet_cross')
    make_synthetic_anet_dataset(anet_root, n_train=1, n_val=4,
                                clip_length=768, crop_size=CROP,
                                spatial=112, seed=6)
    info = os.path.join(anet_root, 'annotations', 'video_info.json')
    npy = os.path.join(anet_root, 'npy')
    with open(info) as f:
        infos = json.load(f)
    val = {k: v for k, v in infos.items() if v['subset'] == 'validation'}
    # the overlapping class: the first validation video's first label
    dropped = next(iter(val.values()))['annotations'][0]['label']
    overlap = os.path.join(root, 'overlapping.txt')
    with open(overlap, 'w') as f:
        f.write(dropped + '\n')
    kept = {k[2:] for k, v in val.items()
            if not any(a['label'] == dropped for a in v['annotations'])}
    cfg = synthetic_test_config(root, **{
        'testing.output_path': os.path.join(root, 'out_cross')})
    forwards = forwards_of(lengths) + ingest_plan(
        [(v['frame_num'], max(v['frame_num'], 768), 0)
         for v in val.values()])[0]
    reset_counts()
    t0 = time.perf_counter()
    merged = test_cross_data.run_cross_data(cfg, info, npy, overlap)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cross = boundary_pool_cuda.LAUNCHES
    assert cross == POOLS_PER_FORWARD * forwards, (cross, forwards)
    with open(merged) as f:
        results = json.load(f)['results']
    assert set(results) == set(lengths) | kept, (set(results), kept)
    n_props = sum(len(v) for v in results.values())
    assert all(math.isfinite(p['score']) for v in results.values()
               for p in v)
    log(f'cross-data: {len(lengths)} THUMOS + {len(val)} ANet videos '
        f'({len(val) - len(kept)} dropped for {dropped}), {n_props} '
        f'proposals, '
        f'{wall:.3f} s, B1 {cross} ({forwards} forwards)')

    # search_param on two of the videos, top_k 200, a GT of 3 segments
    # per video
    names = list(lengths)[:2]
    sub_info = os.path.join(root, 'video_info_2.csv')
    with open(os.path.join(root, 'video_info.csv')) as f:
        rows = f.read().splitlines()
    with open(sub_info, 'w') as f:
        f.write('\n'.join(rows[:3]) + '\n')
    rng = np.random.RandomState(4)
    db = {}
    for name in names:
        secs = lengths[name] / 10.0
        anns = []
        for _ in range(3):
            s = rng.uniform(0, secs - 10)
            anns.append({'segment': [s, s + rng.uniform(2, 10)],
                         'label': f'Class{rng.randint(1, 16):02d}'})
        db[name] = {'subset': 'test', 'annotations': anns}
    gt = os.path.join(root, 'search_gt.json')
    with open(gt, 'w') as f:
        json.dump({'database': db}, f)
    scfg = synthetic_test_config(root, **{
        'dataset.testing.video_info_path': sub_info,
        'testing.top_k': 200,
        'testing.output_path': os.path.join(root, 'out_search')})
    path = write_yaml(scfg, os.path.join(root, 'search.yaml'))
    args = [path, '--gt_json', gt, '--sigmas', '0.3', '0.7',
            '--conf_threshs', '0.01', '0.05']
    runs = []
    for _ in range(2):
        reset_counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            search_param.main(args)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0, boundary_pool_cuda.LAUNCHES,
                     buf.getvalue().strip().splitlines()))
    fwd = sum(-(-len(window_offsets(lengths[n], FRAMES, 128))
                // search_param.MAX_BATCH) for n in names)
    assert runs[0][1] == POOLS_PER_FORWARD * fwd and runs[1][1] == 0, \
        [r[1] for r in runs]
    assert runs[0][2] == runs[1][2] and len(runs[0][2]) == 5, runs
    log(f'search_param: first run {runs[0][0]:.3f} s (B1 {runs[0][1]}, '
        f'{fwd} forwards), second {runs[1][0]:.3f} s reading the cache (B1 '
        f'0), the same mAPs: {runs[0][2]}')
    return {'launches': cross + runs[0][1], 'cross_s': wall,
            'search_s': (runs[0][0], runs[1][0])}


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is false: this run '
              'needs an NVIDIA card', file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    card = card_line()
    log('== phase 1:', card)
    log(f'python {sys.version.split()[0]}, torch {torch.__version__}, '
        f'CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}')
    t0 = time.perf_counter()
    _build.build_all([boundary_pool_cuda.NAME, stem_pack_cuda.NAME])
    log(f'kernels built in {time.perf_counter() - t0:.2f} s '
        f'(nvcc {_build.BUILD_SECONDS})')
    for name, text in _build.BUILD_LOG.items():
        log(f'-- {name}.cu ptxas:\n{text.strip()}')
    t0 = time.perf_counter()
    log(f'libmr (OpenMax\'s Weibull fits, host code) built with g++ into '
        f'{os.path.relpath(libmr.build())} in '
        f'{time.perf_counter() - t0:.2f} s')

    cfg = load_config(CONFIG)
    seeded = factory.init_weights(factory.build_model(
        cfg, frame_num=FRAMES, crop_size=CROP, dtype=torch.float32), seed=0)
    state_dict = seeded.state_dict()

    clips = random_clips(32, 0)
    calls = capture_pool_inputs(build_model(state_dict, torch.bfloat16,
                                            'cuda'), clips)
    assert len(calls) == POOLS_PER_FORWARD, len(calls)
    max_err, tot = phase_kernel_vs_plain(calls)
    del calls
    torch.cuda.empty_cache()
    bwd_err, bwd_tot = phase_bwd_kernel_vs_plain(cfg)
    phase_train_paths(cfg)
    pack_err, pack_times = phase_stem_pack_vs_plain(clips)
    phase_stem_layouts(clips, state_dict[
        'backbone._model.Conv3d_1a_7x7.conv3d.weight'].cuda())
    del clips
    torch.cuda.empty_cache()

    phase_full_width(state_dict)
    phase_full_width_stem(state_dict)
    phase_train_paths_stem(cfg)
    root = tempfile.mkdtemp(prefix='chip_smoke_')
    try:
        launches, lengths, warm_off = phase_end_to_end(state_dict, root)
        v2_launches = phase_end_to_end_stem(root, lengths, warm_off)
        t0 = time.perf_counter()
        dirs, videos = write_packed_dataset(root)
        flow_sd = flow_state_dict(cfg)
        torch.save(flow_sd, os.path.join(root, 'flow.ckpt'))
        log(f'packed videos and flow weights written in '
            f'{time.perf_counter() - t0:.1f} s')
        packed = phase_packed(root, dirs, videos)
        phase_packed_f32(root, dirs, videos)
        b1_w128_err, b4_flow = phase_fused_kernels(state_dict, flow_sd)
        fused = phase_fusion(root, dirs, videos)
        threshold, thr_launches = phase_threshold(root, dirs, videos)
        shared = phase_shared(root, dirs, videos, state_dict)
        shutil.rmtree(dirs['rgb'])
        shutil.rmtree(dirs['flow'])
        launches += packed['launches'] + fused[False]['counts'][0] \
            + fused[True]['counts'][0] + thr_launches \
            + shared['launches'] + shared['stem_b1']
        v2_launches += fused[True]['counts'][3] + shared['b4_launches']
        max_err = max(max_err, b1_w128_err, shared['err'])

        anet_sd = factory.init_weights(factory.build_model(
            anet_cfg(), frame_num=ANET_FRAMES, crop_size=CROP,
            dtype=torch.float32), seed=4).state_dict()
        anet_err, anet_fwd, anet_bwd = phase_anet_kernels(anet_sd)
        max_err = max(max_err, anet_err)
        bwd_err = max(bwd_err, anet_err)
        phase_anet_full_width(anet_sd)
        anet_step = phase_anet_train_step()
        anet = phase_anet_inference(anet_sd, root)
        anet_train_fwd, anet_train_bwd = phase_anet_train_end_to_end(root)
        launches += anet['launches']

        train_fwd, train_bwd, train_cfg = phase_train_end_to_end(root)
        train_fwd += anet_train_fwd
        train_bwd += anet_train_bwd
        v1_launches = phase_train_end_to_end_stem(root, train_cfg)
        rpl = phase_rpl(train_cfg)
        train_fwd += rpl['fwd']
        train_bwd += rpl['bwd']
        openmax = phase_openmax(root)
        cross = phase_cross_search(root, lengths)
        launches += rpl['infer'] + openmax['launches'] + cross['launches']
        phase_train_speed(cfg)
        phase_throughput(state_dict, root, lengths)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    log(f'ActivityNet: B1 {anet_fwd["ms"]} ms per W={ANET_BATCH} forward '
        f'(group bound {anet_fwd["bound_ms"]}, plain {anet_fwd["plain_ms"]}), '
        f'B2 {anet_bwd["ms"]} ms per bs={ANET_TRAIN_BS} step (bound '
        f'{anet_bwd["bound_ms"]}, plain {anet_bwd["plain_ms"]}, scatter_add_ '
        f'{anet_bwd["library_ms"]}); train step {anet_step["ms"]:.1f} ms, '
        f'peak {anet_step["peak"]:.2f} GiB; run_test_anet warm '
        f'{anet["walls"]} s, forward + decode {anet["fwd_ms"]:.2f} ms per '
        f'batch, busy {anet["share"]:.1%}; threshold {anet["threshold"]}; '
        f'launches B1 {anet["launches"]} (inference), {anet_train_fwd} '
        f'(training), B2 {anet_train_bwd}')
    log(f'open-set slice: shared packed warm {shared["walls"]["shared"]} s '
        f'vs default {shared["walls"]["default"]} s, busy '
        f'{shared["share"]:.1%}; B1 per shared forward {shared["b1"]}; B4 at '
        f'the span shape {shared["b4"]}; step ms {rpl["ms"]}, peak GiB '
        f'{rpl["peak"]}; OpenMax stages {openmax["times"]}; cross-data '
        f'{cross["cross_s"]:.3f} s, search_param {cross["search_s"]}')
    log(f'boundary_max_pool_fwd launches: {launches} in the inference runs '
        f'(per-video set, packed, fused off and on, calibration, shared '
        f'packed and per video and with stem_pallas, RPL / GCPL run_test, '
        f'OpenMax, cross-data, search_param; ANet: first, fused, binary, '
        f'calibration), {train_fwd} in the training runs (THUMOS, ANet, '
        f'RPL, GCPL); stem pack v2 {v2_launches} in '
        f'the stem_pallas inference runs (per-video set, fused, shared), v1 '
        f'{v1_launches} in the stem_pallas training run; B4 at C = 2 '
        f'(W=128 bf16) {b4_flow[PACKED_BATCH]}, W=32 {b4_flow[32]}; '
        f'threshold {threshold}')
    log(f'total {time.perf_counter() - t_start:.1f} s')
    source = 'opental_torch/csrc/boundary_pool.cu'
    v1 = pack_times[('v1', torch.float32, 1)]
    v2 = pack_times[('v2', torch.bfloat16, 32)]
    print(json.dumps({'kernels': [{
        'name': 'boundary_max_pool_fwd', 'route': 'cuda', 'source': source,
        'replaces': 'opental_tpu/ops/boundary_pool_pallas.py:38',
        'launches': launches + train_fwd, 'max_abs_err': max_err,
        'ms': tot['ms'], 'plain_ms': tot['plain_ms'],
        'bound_ms': tot['bound_ms'], 'bound_by': 'bytes',
        'library_ms': None}, {
        'name': 'boundary_max_pool_bwd', 'route': 'cuda', 'source': source,
        'replaces': 'opental_tpu/ops/boundary_pool_pallas.py:57',
        'launches': train_bwd, 'max_abs_err': bwd_err,
        'ms': bwd_tot['ms'], 'plain_ms': bwd_tot['plain_ms'],
        'bound_ms': bwd_tot['bound_ms'], 'bound_by': 'bytes',
        'library_ms': bwd_tot['library_ms']}, {
        'name': 'stem_pack96', 'route': 'cuda',
        'source': 'opental_torch/csrc/stem_pack.cu',
        'replaces': 'opental_tpu/ops/stem_pack_pallas.py:44',
        'launches': v1_launches, 'max_abs_err': pack_err['v1'],
        'ms': v1['ms'], 'plain_ms': v1['plain_ms'],
        'bound_ms': v1['bound_ms'], 'bound_by': 'bytes',
        'library_ms': v1['library_ms']}, {
        'name': 'stem_pack96_v2', 'route': 'cuda',
        'source': 'opental_torch/csrc/stem_pack.cu',
        'replaces': 'opental_tpu/ops/stem_pack_pallas.py:141',
        'launches': v2_launches, 'max_abs_err': pack_err['v2'],
        'ms': v2['ms'], 'plain_ms': v2['plain_ms'],
        'bound_ms': v2['bound_ms'], 'bound_by': 'bytes',
        'library_ms': v2['library_ms']}]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
