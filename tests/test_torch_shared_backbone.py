"""The port's shared-backbone inference (`testing.shared_backbone`) on the
CPU, held against the JAX package's shared path.

A span of 4 consecutive windows runs the backbone once and each window's
Mixed_4f / Mixed_5c slice goes through the pyramid; windows then see
their real temporal context at their edges, where the per-window path
sees zero padding (`PARITY.md` "Known deviations"), so the reference
here is JAX's shared `run_test`, not the port's per-window path.

One synthetic dataset (frame 128, crop 32, stride 64: spans of 328
frames) of 4 test videos of 330 to 383 frames, 2 spans each (the second
a tail group of 1 window, its offset snapped up to a multiple of 8),
with random 2-channel flow npys one frame shorter, and seeded port
weights saved as .ckpt files. `testing.packed_frames` 1100 puts two
videos in each flush of the packed path. Held: the detection JSON per
proposal and the evaluator's metrics, per video, packed and fused
(packed); the interior feature alignment; the span plan and the
per-span frames-valid across videos; `model.stem_pallas` on spans.
"""

import json
import os

import numpy as np
import pytest
import torch

from proposal_matching import assert_proposal_parity
from test_torch_packed_inference import eval_shape_variables, write_flow
from torch_suite import suite_policy  # noqa: F401 (autouse)

from opental_tpu.config import load_config as jax_load_config
from opental_tpu.data.thumos import get_class_index_map, get_video_info
from opental_tpu.eval.detection import DetectionEvaluator
from opental_tpu.tools import test as jax_test
from opental_tpu.utils.synthetic import make_synthetic_dataset

from opental_torch import factory
from opental_torch.config import load_config
from opental_torch.infer import pipeline
from opental_torch.infer.pipeline import (InferencePipeline,
                                          snapped_offsets, span_plan,
                                          window_offsets)
from opental_torch.models.bdnet import BDNet
from opental_torch.tools import test as port_test

CLIP, CROP, STRIDE = 128, 32, 64
SPAN = STRIDE * 3 + CLIP + 8
BASE = {'model.compute_dtype': 'float32', 'testing.shared_backbone': True,
        'testing.packed_frames': 1100}


@pytest.fixture(scope='module')
def dataset(tmp_path_factory):
    """(root, config path, overrides with the RGB and flow weights)."""
    root = str(tmp_path_factory.mktemp('shared') / 'synth')
    cfg_path = make_synthetic_dataset(root, n_train=1, n_test=4,
                                      clip_length=CLIP, crop_size=CROP,
                                      video_len_range=(330, 384),
                                      temporal_ramp=True)
    cfg = load_config(cfg_path)
    ckpts = {}
    for name, ch, seed in (('rgb', 3, 0), ('flow', 2, 1)):
        model = factory.init_weights(factory.build_model(
            cfg, frame_num=CLIP, crop_size=CROP, in_channels=ch), seed=seed)
        ckpts[name] = os.path.join(root, f'{name}.ckpt')
        torch.save(model.state_dict(), ckpts[name])
    rgb_dir = cfg.get_path('dataset.testing.video_data_path')
    flow_dir = rgb_dir.replace('_npy', '_flow_npy')
    write_flow(rgb_dir, flow_dir, seed=7)
    overrides = dict(BASE, **{'testing.checkpoint_path': ckpts['rgb']})
    fusion = {'testing.fusion': True,
              'testing.flow_checkpoint_path': ckpts['flow'],
              'testing.rgb_data_path': rgb_dir,
              'testing.flow_data_path': flow_dir}
    return root, cfg_path, overrides, fusion


def jax_run(cfg_path, overrides, pipe=None):
    """JAX's run_test on the config (its pipeline built once per
    stream set and reused: each graph shape compiles once)."""
    cfg = jax_load_config(cfg_path, overrides=overrides)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_test, 'load_variables', eval_shape_variables)
        if pipe is None:
            pipe, _, _ = jax_test.build_pipeline(cfg)
        mp.setattr(jax_test, 'build_pipeline', lambda c: (
            pipe,
            get_video_info(c.get_path('dataset.testing.video_info_path')),
            get_class_index_map(c.get_path('dataset.class_info_path'))[1]))
        return jax_test.run_test(cfg), pipe


MODES = {'per_video': {'testing.packed': False}, 'packed': {}}


@pytest.fixture(scope='module')
def runs(dataset):
    """{mode: (JAX's JSON path, the port's JSON path)}; fused runs
    packed."""
    root, cfg_path, overrides, fusion = dataset
    out, pipe = {}, None
    for mode, extra in MODES.items():
        ov = dict(overrides, **extra)
        want, pipe = jax_run(cfg_path, dict(
            ov, **{'testing.output_json': f'jax_{mode}.json'}), pipe)
        got = port_test.run_test(load_config(cfg_path, overrides=dict(
            ov, **{'testing.output_json': f'port_{mode}.json'})),
            device='cpu')
        out[mode] = (want, got)
    ov = dict(overrides, **fusion)
    want, _ = jax_run(cfg_path, dict(
        ov, **{'testing.output_json': 'jax_fused.json'}))
    got = port_test.run_test(load_config(cfg_path, overrides=dict(
        ov, **{'testing.output_json': 'port_fused.json'})), device='cpu')
    out['fused'] = (want, got)
    return out


def _load(path):
    with open(path) as f:
        return json.load(f)


@pytest.mark.parametrize('mode', ['per_video', 'packed', 'fused'])
def test_shared_json_matches_jax(runs, mode):
    want, got = runs[mode]
    assert_proposal_parity(_load(want), _load(got), min_total=100)


@pytest.mark.parametrize('mode', ['per_video', 'packed', 'fused'])
def test_shared_metrics_equal_jax(dataset, runs, mode):
    anno = os.path.join(dataset[0], 'annotations')

    def metrics(pred):
        ev = DetectionEvaluator(
            os.path.join(anno, 'gt_open.json'), pred,
            os.path.join(anno, 'Class_Index_Known.txt'),
            tiou_thresholds=np.array([0.3, 0.5, 0.7]),
            ood_scoring='uncertainty', subset=['test'], openset=True)
        m, _, _ = ev.evaluate('AP')
        ev.pre_evaluate()
        return np.concatenate([np.atleast_1d(np.asarray(x, np.float64))
                               for x in (m, *ev.evaluate('AUC'),
                                         ev.evaluate('OSDR'))])

    want, got = runs[mode]
    np.testing.assert_allclose(metrics(got), metrics(want), atol=1e-6)


def test_shared_mode_differs_from_per_window(dataset, runs):
    """The shared JSON is not the per-window one (edge context), so the
    comparisons above hold the shared path itself."""
    root, cfg_path, overrides, _ = dataset
    per_window = port_test.run_test(load_config(cfg_path, overrides=dict(
        overrides, **{'testing.shared_backbone': False,
                      'testing.packed_batch': 4,
                      'testing.output_json': 'per_window.json'})),
        device='cpu')
    a, b = _load(per_window)['results'], _load(runs['packed'][1])['results']
    assert set(a) == set(b)
    diff = [abs(x['score'] - y['score']) for v in a
            for x, y in zip(sorted(a[v], key=lambda p: -p['score']),
                            sorted(b[v], key=lambda p: -p['score']))]
    assert max(diff) > 1e-4


# ------------------------------------------------------ alignment / plan


def small_model(**kw):
    return factory.init_weights(BDNet(num_classes=5, os_head=True,
                                      use_edl=True, frame_num=CLIP,
                                      crop_size=CROP, **kw), seed=0).eval()


def test_interior_feature_slices_match_per_window():
    """A window's Mixed_4f / Mixed_5c slice of a long backbone pass equals
    the per-window backbone at the steps whose receptive field lies in
    the window (4f [14, 18), 5c [7, 9) at clip 128); edge steps differ
    (the per-window pass sees zero padding there)."""
    model = small_model()
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.uniform(-1, 1, (1, 3, 384, CROP, CROP)
                                     ).astype(np.float32))
    off = 128
    with torch.no_grad():
        full = model.backbone_features(x)
        win = model.backbone_features(x[:, :, off:off + CLIP])
    for key, s, inner in (('Mixed_4f', 4, slice(14, 18)),
                          ('Mixed_5c', 8, slice(7, 9))):
        shared = full[key][:, :, off // s:off // s + CLIP // s]
        torch.testing.assert_close(shared[:, :, inner],
                                   win[key][:, :, inner], atol=2e-5,
                                   rtol=1e-5)
        assert (shared[:, :, 0] - win[key][:, :, 0]).abs().max() > 1e-4


def test_span_decode_slices_each_window():
    """span_decode's per-window slices feed the same pyramid input as
    slicing the span's features by hand: the decode of window j of a
    span equals the detect on its hand-cut slice."""
    model = small_model()
    pipe = InferencePipeline(model, clip_length=CLIP, stride=STRIDE,
                             crop_size=CROP, use_edl=True, os_head=True,
                             shared_backbone=True, device='cpu')
    rng = np.random.RandomState(1)
    video = torch.from_numpy(rng.randint(0, 256, (SPAN + 40, CROP, CROP, 3),
                                         dtype=np.uint8))
    bases = torch.tensor([0, 40])
    local = torch.tensor([[0, 64, 128, 192], [0, 64, 128, 128]])
    dec = pipe.span_decode([video], bases, local, SPAN + 20)
    assert dec.scores.shape[0] == 8
    x = pipeline.device_windows(video, bases, SPAN + 20, SPAN)
    with torch.no_grad():
        feats = model.backbone_features(x)
        for g, j in ((0, 2), (1, 3)):
            lo = int(local[g, j])
            sl = {'Mixed_4f': feats['Mixed_4f'][g:g + 1, :, lo // 4:
                                                lo // 4 + CLIP // 4],
                  'Mixed_5c': feats['Mixed_5c'][g:g + 1, :, lo // 8:
                                                lo // 8 + CLIP // 8]}
            want = pipe._decode(model.detect_from_features(sl))
            torch.testing.assert_close(dec.scores[4 * g + j],
                                       want.scores[0])
            torch.testing.assert_close(dec.segments[4 * g + j],
                                       want.segments[0])


def test_snapped_offsets_and_span_plan():
    offs = snapped_offsets(443, CLIP, 32)
    assert offs[:-1] == window_offsets(443, CLIP, 32)[:-1]
    assert offs[-1] == 320 and all(o % 8 == 0 for o in offs)
    bases, local, counts = span_plan(offs, 4)
    assert counts == [4, 4, 3]
    assert bases.tolist() == [0, 128, 256]
    assert local.tolist() == [[0, 32, 64, 96]] * 2 + [[0, 32, 64, 64]]
    assert snapped_offsets(100, CLIP, 32) == [0]
    bases, local, counts = span_plan([0], 4)
    assert (bases.tolist(), local.tolist(), counts) == ([0], [[0] * 4],
                                                         [1])


# name: (frames, sample_count)
PLAN_VIDEOS = {'a': (300, 300), 'b': (150, 150), 'c': (341, 400),
               'd': (700, 700)}


def test_packed_spans_across_videos(monkeypatch):
    """run_videos_shared: each video starts at a multiple of 8 and takes
    max(its last span's end, its frames); every span of a flush carries
    its own video's frames-valid; a flush closes before a video would
    pass frames_capacity; each video's result equals its per-video
    shared run."""
    model = small_model()
    pipe = InferencePipeline(model, clip_length=CLIP, stride=STRIDE,
                             crop_size=CROP, top_k=50, use_edl=True,
                             os_head=True, shared_backbone=True,
                             device='cpu')
    pipe.shared_max_groups = 3
    rng = np.random.RandomState(2)
    videos = [(n, rng.randint(0, 256, (t, 40, 40, 3), dtype=np.uint8), c,
               10.0) for n, (t, c) in PLAN_VIDEOS.items()]
    seen = {'stage': [], 'windows': []}
    real_stage, real_windows = pipeline.stage_frames, \
        pipeline.device_windows

    def stage(buf, *a, **kw):
        seen['stage'].append(buf.shape[0])
        return real_stage(buf, *a, **kw)

    def windows(video, offs, valid, clip):
        seen['windows'].append((video.shape[0], offs.clone(),
                                torch.as_tensor(valid).clone()))
        return real_windows(video, offs, valid, clip)

    monkeypatch.setattr(pipeline, 'stage_frames', stage)
    monkeypatch.setattr(pipeline, 'device_windows', windows)
    packed = pipe.run_videos(iter(videos), frames_capacity=1100)

    # the plan, restated
    flushes, cur, cursor, spans = [], [], 0, []
    for name, (t, count) in PLAN_VIDEOS.items():
        bases, _, _ = span_plan(snapped_offsets(count, CLIP, STRIDE), 4)
        need = max(int(bases[-1]) + SPAN, t)
        start = -(-cursor // 8) * 8
        if cur and start + need > 1100:
            flushes.append((cur, cursor))
            cur, start = [], 0
        cur.append(name)
        spans += [(start + int(b), start + min(t, count)) for b in bases]
        cursor = start + need
    flushes.append((cur, cursor))
    assert [len(f[0]) for f in flushes] == [2, 1, 1]
    assert seen['stage'] == [c for _, c in flushes]
    got = [(int(b), int(v)) for _, o, fv in seen['windows']
           for b, v in zip(o, fv)]
    assert got == spans
    assert all(len(o) <= 3 for _, o, _ in seen['windows'])
    for size, o, _ in seen['windows']:
        assert int(o.max()) + SPAN <= size

    monkeypatch.undo()
    for name, data, count, fps in videos:
        want = pipe.run_video(data, count, fps)
        got = packed[name]
        assert len(want) == len(got) > 0
        for a, b in zip(sorted(want, key=lambda p: -p['score']),
                        sorted(got, key=lambda p: -p['score'])):
            np.testing.assert_allclose(a['score'], b['score'], rtol=1e-4)


def test_shared_spans_with_stem_pallas():
    """model.stem_pallas (the stem-pack path) on the spans gives the
    proposals of the plain stem: the same math."""
    rng = np.random.RandomState(3)
    video = rng.randint(0, 256, (350, 40, 40, 3), dtype=np.uint8)
    props = []
    for stem in (False, True):
        pipe = InferencePipeline(small_model(stem_pallas=stem),
                                 clip_length=CLIP, stride=STRIDE,
                                 crop_size=CROP, top_k=50, use_edl=True,
                                 os_head=True, shared_backbone=True,
                                 device='cpu')
        props.append(pipe.run_video(video, 350, 10.0))
    assert len(props[0]) == len(props[1]) > 0
    for a, b in zip(*props):
        assert a['cls'] == b['cls']
        np.testing.assert_allclose(a['score'], b['score'], rtol=1e-4)
        np.testing.assert_allclose(a['segment'], b['segment'], rtol=1e-4,
                                   atol=1e-4)


def test_shared_cli_flags(dataset):
    """build_pipeline reads testing.shared_backbone."""
    _, cfg_path, overrides, _ = dataset
    for flag in (True, False):
        pipe, _, _ = port_test.build_pipeline(load_config(
            cfg_path, overrides=dict(overrides, **{
                'testing.shared_backbone': flag})), device='cpu')
        assert pipe.shared_backbone is flag
        assert pipe.span == SPAN
