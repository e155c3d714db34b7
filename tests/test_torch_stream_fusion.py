"""Two-stream fusion and ActivityNet inference against the benchmark's
plain reference (`tal_bench/reference`: plain PyTorch, float32), on the
CPU in float32 at a small size, on seeded random weights
(`tal_bench.weights`, whose head biases put every class of every prior
over the score floors, so post-processing has work).

* The packed fused `run_videos` (RGB + a 2-channel flow BDNet, the flow
  a frame shorter): the fused outputs the pipeline decodes, each window
  against the reference's two BDNets on the same windows fused by
  `reference.decode.fuse_streams`.
* `tools.test_anet.AnetInference` over in-memory videos (one shorter
  than the clip, one longer, a padded tail batch): each video's model
  outputs against `reference.anet_pyramid`'s BDNet, and its proposals
  against the plain ANet post-processing (`reference.anet_post`) of
  those outputs.
* The `stream.*` spans and counters record only while recording, and
  the fused outputs are bit-equal with the recording on and off.

Tolerances. Both sides compute in float32 on the CPU and differ only in
the order of their sums (convolution algorithms, the pool's reductions):
the heads read ~1e-6 apart, relative l2, so `MODEL_RTOL` 1e-4 leaves a
hundred-fold room while a bfloat16 model reads above 1e-3. Proposals
are held on the program's own outputs by `reference.post.gap` (scores
rank by rank, every proposal over 0.01 found on the other side within
1 ms): the torch and NumPy soft-NMS round their decays alike to ~1e-7,
so `POST_GAP` 1e-4 holds them far under one missing proposal (+1).
"""

import os

import numpy as np
import pytest
import torch
import yaml

from torch_suite import suite_policy  # noqa: F401 (autouse)

from opental_torch import factory
from opental_torch.config import load_config
from opental_torch.infer import pipeline
from opental_torch.infer.pipeline import InferencePipeline
from opental_torch.tools.test_anet import AnetInference
from opental_torch.utils import profiling
from tal_bench import program, weights
from tal_bench.compare import rel_gap
from tal_bench.reference import anet_post, build, decode, post

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THUMOS = os.path.join(ROOT, 'configs', 'thumos14_opental_final.yaml')
ANET = os.path.join(ROOT, 'configs', 'anet_opental.yaml')
CROP = 32
MODEL_RTOL = 1e-4
POST_GAP = 1e-4
KEYS = ('loc', 'conf', 'prop_loc', 'prop_conf', 'center', 'act',
        'prop_act', 'unct', 'prop_unct')


def configs(path, clip):
    """(the port's Config, the plain dict the reference reads) at
    `clip` frames, 32 x 32 crops, float32."""
    over = {'dataset.testing.clip_length': clip,
            'dataset.testing.clip_stride': clip // 2,
            'dataset.testing.crop_size': CROP,
            'model.compute_dtype': 'float32'}
    with open(path) as f:
        raw = yaml.safe_load(f)
    return load_config(path, overrides=over), program.merged(raw, over)


def seeded(cfg, clip, seed, in_channels=None):
    model = factory.build_model(cfg, frame_num=clip, crop_size=CROP,
                                dtype=torch.float32, in_channels=in_channels)
    return weights.seed_weights(model, seed, 'infer').eval()


def reference(raw, clip, model, in_channels=3):
    ref = build.model(program.merged(raw, {'model.in_channels': in_channels}),
                      clip, CROP)
    return build.load(ref, model.state_dict()).eval()


def frames(rng, n, channels, spatial=40):
    """Seeded uint8 frames with a slow ramp (so windows differ)."""
    noise = rng.integers(30, 226, (n, spatial, spatial, channels))
    ramp = (np.arange(n) % 64)[:, None, None, None] - 32
    return np.clip(noise + ramp, 0, 255).astype(np.uint8)


def cut(data, offsets, clip):
    """(W, C, clip, crop, crop) float32 windows: centre crop, (x / 255) *
    2 - 1, zero past the frames' end."""
    lo = (data.shape[1] - CROP) // 2
    x = torch.from_numpy(data[:, lo:lo + CROP, lo:lo + CROP].astype(
        np.float32))
    out = torch.zeros((len(offsets), clip, CROP, CROP, data.shape[-1]))
    for i, o in enumerate(offsets):
        part = x[o:o + clip]
        out[i, :len(part)] = (part / 255.0) * 2.0 - 1.0
    return out.permute(0, 4, 1, 2, 3)


def ref_outputs(ref, x):
    with torch.no_grad():
        o = ref(x)
    return {k: o[k] for k in KEYS if o.get(k) is not None}


def test_packed_fused_outputs_match_reference():
    clip = 128
    cfg, raw = configs(THUMOS, clip)
    rgb, flow = seeded(cfg, clip, 3), seeded(cfg, clip, 4, in_channels=2)
    pipe = InferencePipeline(rgb, clip_length=clip, stride=clip // 2,
                             crop_size=CROP, use_edl=True, os_head=True,
                             flow_model=flow, device='cpu')
    fused = []
    decode_real = pipe._decode
    pipe._decode = lambda out: fused.append(out) or decode_real(out)
    rng = np.random.default_rng(7)
    n = 300
    video, flow_video = frames(rng, n, 3), frames(rng, n - 1, 2)
    results = pipe.run_videos(iter([('v', video, n, 10.0, flow_video)]),
                              max_batch=8, frames_capacity=1024)
    assert len(fused) == 1 and results['v']
    offsets = pipeline.window_offsets(n, clip, clip // 2)
    want = decode.fuse_streams(
        ref_outputs(reference(raw, clip, rgb), cut(video, offsets, clip)),
        ref_outputs(reference(raw, clip, flow, 2),
                    cut(flow_video, offsets, clip)))
    got = {k: v[:len(offsets)] for k, v in fused[0].items() if k in KEYS}
    assert rel_gap(got, want) < MODEL_RTOL
    # the flow stream matters: the RGB outputs alone read far off
    rgb_only = ref_outputs(reference(raw, clip, rgb),
                           cut(video, offsets, clip))
    assert rel_gap(rgb_only, want) > 100 * MODEL_RTOL


def test_anet_inference_matches_reference():
    clip = 256
    cfg, raw = configs(ANET, clip)
    model = seeded(cfg, clip, 5)
    got = []
    model.register_forward_hook(lambda m, a, out: got.append(
        {k: out[k] for k in KEYS + ('priors',) if out.get(k) is not None}))
    infer = AnetInference(cfg, model, video_batch=2, device='cpu')
    rng = np.random.default_rng(11)
    videos = [(f'v_{i}', frames(rng, n, 3), n / d, d)
              for i, (n, d) in enumerate(((200, 40.0), (300, 75.5),
                                          (256, 12.0)))]
    results = infer.run(iter(videos))
    assert len(got) == 2 and set(results) == {v[0] for v in videos}
    ref = reference(raw, clip, model)
    for i, (name, data, fps, duration) in enumerate(videos):
        prog = {k: v[i % 2:i % 2 + 1] if k != 'priors' else v
                for k, v in got[i // 2].items()}
        want = ref_outputs(ref, cut(data, [0], clip))
        assert rel_gap(prog, want) < MODEL_RTOL, name
        dec = decode.decode_windows(prog, clip, use_edl=True, os_head=True,
                                    score_func='dirichlet')
        plain = anet_post.proposals(dec, fps, duration, num_classes=150,
                                    os_head=True, use_edl=True,
                                    n_candidates=512, sigma=0.85,
                                    top_k=5000)
        assert len(results[name]) > 100
        assert post.gap(results[name], plain) < POST_GAP, name
        assert all(0.0 <= p['segment'][0] < p['segment'][1] <= duration
                   for p in results[name])


class FakeEvent:
    made = 0

    def __init__(self, enable_timing=False):
        FakeEvent.made += 1

    def record(self, stream=None):
        pass

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return 2.5


def test_stream_spans_and_counters_only_while_recording(monkeypatch):
    clip = 128
    cfg, _ = configs(THUMOS, clip)
    pipe = InferencePipeline(seeded(cfg, clip, 3), clip_length=clip,
                             stride=clip // 2, crop_size=CROP, use_edl=True,
                             os_head=True,
                             flow_model=seeded(cfg, clip, 4, in_channels=2),
                             device='cpu')
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.uniform(-1, 1, (2, 3, clip, CROP, CROP))
                         .astype(np.float32))
    xf = torch.from_numpy(rng.uniform(-1, 1, (2, 2, clip, CROP, CROP))
                          .astype(np.float32))
    names = ('stream.rgb', 'stream.flow', 'fuse')
    with profiling.recording():
        pass                                  # an empty store
    off = pipe.forward_decode(x, xf)
    assert not profiling.recorded().spans
    with profiling.recording():
        on = pipe.forward_decode(x, xf)
    rec = profiling.recorded()
    assert [s.name for s in rec.spans if s.name in names] == list(names)
    # off the card no event is made and no stream time is counted
    assert not [c for c in rec.counts if c.name.startswith('stream.')]
    for a, b in zip(off, on):
        assert a is None and b is None or torch.equal(a, b)

    monkeypatch.setattr(torch.cuda, 'Event', FakeEvent)
    card = torch.device('cuda')
    with profiling.device_ms('stream.flow_ms', card):
        pass
    assert FakeEvent.made == 0
    with profiling.recording():
        with profiling.span('stream.flow'), \
                profiling.device_ms('stream.flow_ms', card):
            pass
        with profiling.device_ms('stream.rgb_ms', torch.device('cpu')):
            pass
    assert FakeEvent.made == 2
    counts = [(c.name, c.n) for c in profiling.recorded().counts]
    assert counts == [('stream.flow_ms', 2.5)]
