#!/usr/bin/env python3
"""Drive the PyTorch port (opental_torch) on one NVIDIA card.

    python3 chip_smoke.py            # from the root of a checkout

Phases (any failure ends the run with a non-zero exit):
  1. card, versions; build the CUDA kernels from csrc/ (nvcc, in parallel)
  2. every hand kernel vs its plain PyTorch version on the card, at the
     inputs the main path gives it (captured from a full-width forward
     at W=32) and on adversarial inputs, in float32 and bfloat16; times
     of kernel, plain version and bound per shape
  3. the full-width OpenTAL-final BDNet (256 x 96 x 96, seeded weights) in
     float32 with TF32 off: card vs CPU at W=1, kernel path vs plain path
     at W=32, 24 kernel launches per forward
  4. the main path end to end: synthetic uint8 videos through
     opental_torch.tools.test.run_test at the default bf16, to a
     detection JSON; launch counts are read from this run only
  5. forward + decode windows/s at W=32 and W=128 (bf16), soft-NMS time
     per video
Then a `kernels` JSON line, the card's name and power limit, and as the
last line {"ok": true, "device": {...}}. Weights and data are random,
made from seeds; no network, one card.
"""

from __future__ import annotations

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

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from opental_torch import factory  # noqa: E402
from opental_torch.config import load_config  # noqa: E402
from opental_torch.infer.pipeline import (InferencePipeline,  # noqa: E402
                                          window_offsets)
from opental_torch.models import pyramid  # noqa: E402
from opental_torch.models.bdnet import BDNet  # noqa: E402
from opental_torch.ops import _build, boundary_pool, boundary_pool_cuda  # noqa: E402
from opental_torch.tools.test import run_test  # noqa: E402

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
FRAMES, CROP, CLASSES = 256, 96, 16
CONFIG = 'configs/thumos14_opental_final.yaml'
OUT_KEYS = ('loc', 'conf', 'prop_loc', 'prop_conf', 'center', 'act',
            'prop_act', 'start', 'end', 'start_loc_prop', 'end_loc_prop',
            'start_conf_prop', 'end_conf_prop', 'unct', 'prop_unct')


def log(*a):
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


def pool_bound_ms(x: torch.Tensor, seg: torch.Tensor) -> float:
    """Least time for one pool call: the x rows its windows cover (each
    read once), the segments and the output, over the memory rate."""
    b, t_len, c = x.shape
    l, r = boundary_pool.clamp_windows(seg, t_len)          # (B, K, 2)
    pos = torch.arange(t_len, device=x.device)
    cover = ((pos >= l[..., None]) & (pos <= r[..., None])).any(dim=1)
    rows = int(cover.sum())                                 # (b, half, t)
    nbytes = (rows * (c // 2) * x.element_size() + seg.numel() * 4
              + b * seg.shape[1] * c * x.element_size())
    return nbytes / HBM_BYTES_PER_S * 1e3


def random_clips(n: int, seed: int) -> torch.Tensor:
    """(n, 3, FRAMES, CROP, CROP) float32 clips in [-1, 1], made on the
    card from a seed."""
    g = torch.Generator(device='cuda').manual_seed(seed)
    u8 = torch.randint(0, 256, (n, 3, FRAMES, CROP, CROP), generator=g,
                       device='cuda', dtype=torch.uint8)
    return (u8.float() / 255.0) * 2.0 - 1.0


def build_model(state_dict, dtype, device) -> BDNet:
    m = BDNet(num_classes=CLASSES, os_head=True, use_edl=True,
              evidence='exp', frame_num=FRAMES, crop_size=CROP,
              dtype=None if dtype == torch.float32 else dtype)
    m.load_state_dict(state_dict, strict=True)
    return m.to(device).eval()


def capture_pool_inputs(model: BDNet, clips: torch.Tensor):
    """(x, segments) of every boundary-pool call of one forward."""
    calls = []
    real = pyramid.boundary_max_pool

    def recording(x, seg):
        calls.append((x.clone(), seg.clone()))
        return real(x, seg)

    pyramid.boundary_max_pool = recording
    try:
        with torch.inference_mode():
            model(clips)
    finally:
        pyramid.boundary_max_pool = real
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


def phase_kernel_vs_plain(calls):
    log('== phase 2: boundary_max_pool_fwd vs plain version on the card')
    max_err = 0.0
    for i, (x, seg) in enumerate(calls):
        for dtype in (torch.float32, torch.bfloat16):
            xd = x.to(dtype).contiguous()
            for segs in (seg, adversarial_segments(
                    x.shape[0], seg.shape[1], x.shape[1], i)):
                got = boundary_pool_cuda.boundary_max_pool_fwd(xd, segs)
                with boundary_pool.force_plain():
                    want = boundary_pool.boundary_max_pool(xd, segs)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                max_err = max(max_err, err)
                if not torch.equal(got, want):
                    raise AssertionError(f'kernel != plain: call {i} '
                                         f'{tuple(x.shape)} {dtype} err {err}')
    log(f'kernel == plain exactly on {len(calls)} main-path calls x '
        f'(f32, bf16) x (captured, adversarial) segments; max_abs_err '
        f'{max_err}')

    # time: the 24 calls of one forward (12 shapes, 2 branches)
    rows = []
    tot = {'ms': 0.0, 'call_ms': 0.0, 'plain_ms': 0.0, 'bound_ms': 0.0}
    for i, (x, seg) in enumerate(calls):
        def kernel():
            boundary_pool_cuda.boundary_max_pool_fwd(x, seg)

        def plain():
            with boundary_pool.force_plain():
                boundary_pool.boundary_max_pool(x, seg)

        r = {'ms': device_ms(kernel, reps=50),
             'call_ms': time_ms(kernel, reps=50),
             'plain_ms': device_ms(plain, reps=5),
             'bound_ms': pool_bound_ms(x, seg)}
        for key in tot:
            tot[key] += r[key]
        rows.append((i, tuple(x.shape), seg.shape[1], r))
    log('device times (ms): kernel, kernel per call with host overhead, '
        'plain version, bound (bytes / 3.35 TB/s)')
    log('call  x(B,T,C)           K    kernel   k+host     plain     '
        'bound  bound/kernel')
    for i, shape, k, r in rows:
        log(f'{i:4d}  {str(shape):18s} {k:3d}  {r["ms"]:.5f}  '
            f'{r["call_ms"]:.5f}  {r["plain_ms"]:.5f}  {r["bound_ms"]:.6f}  '
            f'{r["bound_ms"] / r["ms"]:.3f}')
    log(f'one forward (24 calls, W=32, f32 inputs): kernel {tot["ms"]} ms '
        f'({tot["call_ms"]} ms with host overhead), plain '
        f'{tot["plain_ms"]} ms, bound {tot["bound_ms"]} ms')
    return max_err, tot


def phase_full_width(state_dict):
    log('== phase 3: full-width BDNet f32, TF32 off')
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        compare_full_width(state_dict)
    finally:
        # the later phases measure the main path with PyTorch's defaults
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32


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
    torch.backends.cudnn.deterministic = True
    before = boundary_pool_cuda.LAUNCHES
    with torch.inference_mode():
        out_k = model(clips)
    launched = boundary_pool_cuda.LAUNCHES - before
    with torch.inference_mode(), boundary_pool.force_plain():
        out_p = model(clips)
    torch.cuda.synchronize()
    torch.backends.cudnn.deterministic = False
    assert launched == 24, f'{launched} kernel launches in one forward'
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


def phase_end_to_end(state_dict, root):
    log('== phase 4: main path end to end (tools.test.run_test, bf16)')
    lengths = write_dataset(root)
    ckpt = os.path.join(root, 'checkpoint-1.ckpt')
    torch.save(state_dict, ckpt)
    cfg = load_config(CONFIG, overrides={
        'dataset.class_info_path': os.path.join(root, 'classes.txt'),
        'dataset.testing.video_info_path': os.path.join(root,
                                                        'video_info.csv'),
        'dataset.testing.video_data_path': os.path.join(root, 'test_npy'),
        'testing.checkpoint_path': ckpt,
        'testing.output_path': os.path.join(root, 'out'),
    })
    n_windows = sum(len(window_offsets(t, FRAMES, 128))
                    for t in lengths.values())
    n_forwards = sum(math.ceil(len(window_offsets(t, FRAMES, 128)) / 128)
                     for t in lengths.values())
    boundary_pool_cuda.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = run_test(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = boundary_pool_cuda.LAUNCHES
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
    assert launches == 24 * n_forwards, (launches, n_forwards)
    log(f'videos {len(lengths)}, windows {n_windows}, proposals {n_props}, '
        f'wall {wall:.3f} s, {n_windows / wall:.2f} windows/s (first run, '
        f'includes video load, upload and post-processing)')
    log(f'boundary_max_pool_fwd launches in this run: {launches} '
        f'({n_forwards} forwards x 24)')
    cfg.testing['output_json'] = 'warm.json'
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_test(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    log(f'second (warm) run: wall {wall:.3f} s, {n_windows / wall:.2f} '
        f'windows/s')
    return launches, lengths


def profile_device(fn, label: str, top: int = 8) -> None:
    """Kernel time by name over one fn() (torch.profiler), the device's
    busy share of that call's wall time (profiling on), and the same
    device time by the PyTorch op (and input shapes) that launched it."""
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
            and e.self_device_time_total > 0]
    busy = sum(r[0] for r in rows)
    if not rows:
        log(f'profile {label}: the profiler recorded no device time')
        return
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


def phase_throughput(state_dict, root, lengths):
    log(f'== phase 5: forward + decode throughput (bf16), soft-NMS time, '
        f'on {card_line()}')
    model = build_model(state_dict, torch.bfloat16, 'cuda')
    pipe = InferencePipeline(model, clip_length=FRAMES, stride=128,
                             crop_size=CROP, top_k=5000, use_edl=True,
                             os_head=True, device='cuda')
    for w in (32, 128):
        clips = random_clips(w, seed=2)
        ms = time_ms(lambda: pipe.forward_decode(clips), reps=5, warmup=2)
        log(f'forward+decode W={w}: {ms:.2f} ms, {w / ms * 1e3:.1f} '
            f'windows/s')
        if w == 32:
            profile_device(lambda: pipe.forward_decode(clips),
                           'forward+decode W=32')
        del clips
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
    _build.build_all([boundary_pool_cuda.NAME])
    log(f'kernels built in {time.perf_counter() - t0:.2f} s '
        f'(nvcc {_build.BUILD_SECONDS})')
    for name, text in _build.BUILD_LOG.items():
        log(f'-- {name}.cu ptxas:\n{text.strip()}')

    cfg = load_config(CONFIG)
    seeded = factory.init_weights(factory.build_model(
        cfg, frame_num=FRAMES, crop_size=CROP, dtype=torch.float32), seed=0)
    state_dict = seeded.state_dict()

    calls = capture_pool_inputs(build_model(state_dict, torch.bfloat16,
                                            'cuda'), random_clips(32, 0))
    assert len(calls) == 24, len(calls)
    max_err, tot = phase_kernel_vs_plain(calls)
    del calls
    torch.cuda.empty_cache()

    phase_full_width(state_dict)
    root = tempfile.mkdtemp(prefix='chip_smoke_')
    try:
        launches, lengths = phase_end_to_end(state_dict, root)
        phase_throughput(state_dict, root, lengths)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    log(f'total {time.perf_counter() - t_start:.1f} s')
    print(json.dumps({'kernels': [{
        'name': 'boundary_max_pool_fwd', 'route': 'cuda',
        'source': 'opental_torch/csrc/boundary_pool.cu',
        'replaces': 'opental_tpu/ops/boundary_pool_pallas.py:38',
        'launches': launches, 'max_abs_err': max_err,
        'ms': tot['ms'], 'plain_ms': tot['plain_ms'],
        'bound_ms': tot['bound_ms'], 'bound_by': 'bytes',
        'library_ms': None}]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
