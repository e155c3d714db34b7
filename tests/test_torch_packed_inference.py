"""The port's dataset-scale THUMOS14 inference on the CPU: packed device
ingest across videos, RGB + flow fusion and the host-staged modes, held
against the JAX package and against the port's own per-video path.

One synthetic dataset (`opental_tpu.utils.synthetic`, frame 128, crop
32, stride 64) with random 2-channel flow npys one frame shorter than
their RGB, and one pair of seeded port weights (RGB, flow) saved as
torch .ckpt files. JAX's `tools.test.run_test` runs once, fused, in
float32, in its default mode (packed device ingest + fused device post):
it loads the .ckpt files through its own converter onto a template of
`jax.eval_shape` of its init (`load_variables` patched only so that the
init is not compiled). `packed_batch` 4 and `packed_frames` 512 make
both packages pack windows of several videos into one forward, flush
more than once and pad tail batches. The port's fused packed JSON must
agree with JAX's per proposal with equal evaluator metrics; the
port's per-video and host-staged JSONs must agree with its packed one
per proposal (rtol 1e-4, as `tests/test_packed_inference.py`). JAX's
calibration reuses the same pipeline over the training videos (so the
fused forward compiles once), and the port's `tools.threshold` CLI must
give its threshold at rtol 1e-4.

The scheduler's edge cases run on in-memory videos through
`InferencePipeline.run_videos`, each video held against `run_video`; so
do the runs that post-process each flush one flush behind (RGB, fused,
and a single flush), with their order and the `post.behind` counter.
"""

import json
import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from proposal_matching import assert_proposal_parity
from torch_suite import suite_policy  # noqa: F401 (autouse)

from opental_tpu.config import load_config as jax_load_config
from opental_tpu.data.thumos import get_class_index_map, get_video_info
from opental_tpu.eval.detection import DetectionEvaluator
from opental_tpu.openset import threshold as jax_threshold
from opental_tpu.tools import test as jax_test
from opental_tpu.utils.propmatch import pair_proposals
from opental_tpu.utils.synthetic import make_synthetic_dataset
from opental_tpu.utils.torch_convert import (align_bn_collections,
                                             convert_bdnet_checkpoint,
                                             merge_variables)

from opental_torch import factory
from opental_torch.config import load_config
from opental_torch.infer import pipeline
from opental_torch.infer.pipeline import (InferencePipeline, device_windows,
                                          ingest_windows, stack_windows,
                                          stack_windows_u8, stage_frames,
                                          window_offsets)
from opental_torch.models import pyramid
from opental_torch.models.bdnet import BDNet
from opental_torch.tools import test as port_test
from opental_torch.tools import threshold as threshold_cli
from opental_torch.utils import profiling

CLIP, CROP, STRIDE = 128, 32, 128
PACKING = {'model.compute_dtype': 'float32', 'testing.packed_batch': 4,
           'testing.packed_frames': 512}


def eval_shape_variables(model, checkpoint_path, sample_shape):
    """JAX's `tools.test.load_variables` with the init template from
    `jax.eval_shape` instead of a compiled init (the converted weights
    replace every leaf: strict merge)."""
    template = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                              jnp.zeros(sample_shape, jnp.float32))
    loaded = align_bn_collections(convert_bdnet_checkpoint(checkpoint_path),
                                  template['params'])
    return {k: merge_variables(template[k], loaded[k], strict=True)
            for k in ('params', 'constants')}


def write_flow(rgb_dir, flow_dir, seed):
    """Random uint8 2-channel flow npys, each one frame shorter than its
    RGB (TVL1 flow npys are)."""
    os.makedirs(flow_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    for name in sorted(os.listdir(rgb_dir)):
        rgb = np.load(os.path.join(rgb_dir, name), mmap_mode='r')
        np.save(os.path.join(flow_dir, name),
                rng.randint(0, 255, (rgb.shape[0] - 1,) + rgb.shape[1:3]
                            + (2,), dtype=np.uint8))


def fusion_dataset(root):
    """(config path, fusion overrides): the synthetic dataset, flow npys
    of both splits and the seeded RGB / flow port checkpoints."""
    cfg_path = make_synthetic_dataset(root, n_train=3, n_test=3,
                                      clip_length=CLIP, crop_size=CROP)
    with open(cfg_path) as f:
        raw = yaml.safe_load(f)
    cfg = load_config(cfg_path)
    ckpts = {}
    for name, ch, seed in (('rgb', 3, 0), ('flow', 2, 1)):
        model = factory.init_weights(factory.build_model(
            cfg, frame_num=CLIP, crop_size=CROP, in_channels=ch), seed=seed)
        ckpts[name] = os.path.join(root, f'{name}.ckpt')
        torch.save(model.state_dict(), ckpts[name])
    dirs = {}
    for split, seed in (('testing', 7), ('training', 8)):
        rgb_dir = raw['dataset'][split]['video_data_path']
        dirs[split] = (rgb_dir, rgb_dir.replace('_npy', '_flow_npy'))
        write_flow(rgb_dir, dirs[split][1], seed)
    fusion = {'testing.fusion': True,
              'testing.checkpoint_path': ckpts['rgb'],
              'testing.flow_checkpoint_path': ckpts['flow'],
              'testing.rgb_data_path': dirs['testing'][0],
              'testing.flow_data_path': dirs['testing'][1],
              'training.rgb_data_path': dirs['training'][0],
              'training.flow_data_path': dirs['training'][1]}
    return cfg_path, fusion


@pytest.fixture(scope='module')
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('packed') / 'synth')
    cfg_path, fusion = fusion_dataset(root)
    return root, cfg_path, dict(PACKING, **fusion)


@pytest.fixture(scope='module')
def jax_pipeline(dataset):
    """JAX's fused pipeline, built once: its run_test and its calibration
    share the compiled forward."""
    _, cfg_path, overrides = dataset
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_test, 'load_variables', eval_shape_variables)
        pipe, _, _ = jax_test.build_pipeline(jax_load_config(
            cfg_path, overrides=overrides))
    return pipe


@pytest.fixture(scope='module')
def jax_fused(dataset, jax_pipeline):
    """JAX's run_test (fused, default mode) -> its detection JSON path."""
    _, cfg_path, overrides = dataset
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_test, 'build_pipeline', lambda cfg: (
            jax_pipeline,
            get_video_info(cfg.get_path('dataset.testing.video_info_path')),
            get_class_index_map(cfg.get_path('dataset.class_info_path'))[1]))
        return jax_test.run_test(jax_load_config(cfg_path, overrides=dict(
            overrides, **{'testing.output_json': 'jax_fused.json'})))


PORT_MODES = {
    'packed': {},
    'per_video': {'testing.packed': False},
    'host_packed': {'testing.device_ingest': False},
    'host_per_video': {'testing.device_ingest': False,
                       'testing.packed': False},
}


@pytest.fixture(scope='module')
def port_fused(dataset):
    """{mode: detection JSON} of the port's fused runs."""
    root, cfg_path, overrides = dataset
    out = {}
    for mode, extra in PORT_MODES.items():
        path = port_test.run_test(load_config(cfg_path, overrides=dict(
            overrides, **extra, **{'testing.output_json': f'{mode}.json'})),
            device='cpu')
        with open(path) as f:
            out[mode] = json.load(f)
    return out


def test_fused_packed_json_matches_jax(jax_fused, port_fused):
    with open(jax_fused) as f:
        want = json.load(f)
    assert set(port_fused['packed']) == {'version', 'results',
                                         'external_data'}
    assert_proposal_parity(want, port_fused['packed'], min_total=100)


def test_fused_packed_metrics_equal_jax(dataset, jax_fused, port_fused):
    root = dataset[0]
    anno = os.path.join(root, 'annotations')
    port_path = os.path.join(root, 'port_packed_for_eval.json')
    with open(port_path, 'w') as f:
        json.dump(port_fused['packed'], f)

    def metrics(pred):
        ev = DetectionEvaluator(
            os.path.join(anno, 'gt_open.json'), pred,
            os.path.join(anno, 'Class_Index_Known.txt'),
            tiou_thresholds=np.array([0.3, 0.5, 0.7]),
            ood_scoring='uncertainty', subset=['test'], openset=True)
        mAP, _, _ = ev.evaluate('AP')
        ev.pre_evaluate()
        auc = ev.evaluate('AUC')
        osdr = ev.evaluate('OSDR')
        return np.concatenate([np.atleast_1d(np.asarray(x, np.float64))
                               for x in (mAP, *auc, osdr)])

    np.testing.assert_allclose(metrics(port_path), metrics(jax_fused),
                               atol=1e-6)


def assert_same(props_a, props_b):
    """`tests/test_packed_inference.py::_assert_same` on JSON proposals:
    tie-robust pairing, same class, score and segment at rtol 1e-4."""
    assert len(props_a) == len(props_b)

    def cls(props):
        return [dict(p, cls=p['label']) for p in props]

    for a, b in pair_proposals(cls(props_a), cls(props_b)):
        assert a['cls'] == b['cls']
        np.testing.assert_allclose(a['score'], b['score'], rtol=1e-4)
        np.testing.assert_allclose(a['segment'], b['segment'], rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(a['uncertainty'], b['uncertainty'],
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(a['actionness'], b['actionness'],
                                   rtol=1e-4)


@pytest.mark.parametrize('mode', ['per_video', 'host_packed',
                                  'host_per_video'])
def test_fused_modes_match_packed(port_fused, mode):
    want, got = port_fused['packed']['results'], port_fused[mode]['results']
    assert set(got) == set(want)
    assert sum(len(v) for v in want.values()) > 100
    for name in want:
        assert_same(want[name], got[name])


# -------------------------------------------------- threshold calibration


def set_path(tree, dotted, value):
    *parents, leaf = dotted.split('.')
    for p in parents:
        tree = tree.setdefault(p, {})
    tree[leaf] = value


def cli_config(cfg_path, overrides, path):
    """The dataset's YAML with `overrides` written in (the CLIs read all
    but their flags from the file)."""
    with open(cfg_path) as f:
        raw = yaml.safe_load(f)
    for k, v in overrides.items():
        set_path(raw, k, v)
    with open(path, 'w') as f:
        yaml.safe_dump(raw, f)
    return path


@pytest.fixture(scope='module')
def jax_calibration(dataset, jax_pipeline):
    """JAX's `openset.threshold.calibrate` over the training videos with
    the fused pipeline -> (threshold, JSON path)."""
    _, cfg_path, overrides = dataset
    cfg = jax_load_config(cfg_path, overrides=dict(
        overrides, **{'testing.output_json': 'jax_thr.json'}))
    thr = jax_threshold.calibrate(cfg, jax_pipeline)
    return thr, os.path.join(cfg.testing['output_path'], 'jax_thr.json')


def test_threshold_cli_matches_jax_calibrate(dataset, jax_calibration,
                                             capsys):
    """`python -m opental_torch.tools.threshold <cfg> --fusion --device
    cpu` over the training videos: JAX's threshold at rtol 1e-4 and its
    thresholding JSON per proposal; a second call reads the file back."""
    root, cfg_path, overrides = dataset
    jax_thr, jax_path = jax_calibration
    cfg = cli_config(cfg_path, overrides,
                     os.path.join(root, 'threshold.yaml'))
    outs = []
    for _ in range(2):
        threshold_cli.main([cfg, '--device', 'cpu', '--fusion',
                            '--output_json', 'port_thr.json'])
        outs.append(capsys.readouterr().out)
    thr = [float(o.rsplit('The threshold is: ', 1)[1].split()[0])
           for o in outs]
    np.testing.assert_allclose(thr[0], jax_thr, rtol=1e-4)
    assert 'already exist' in outs[1] and thr[1] == thr[0]
    with open(jax_path) as f:
        want = json.load(f)
    with open(os.path.join(os.path.dirname(jax_path), 'port_thr.json')) as f:
        got = json.load(f)
    np.testing.assert_allclose(got['external_data']['threshold'], jax_thr,
                               rtol=1e-4)
    assert len(got['results']) == 3
    assert_proposal_parity(want, got, min_total=100)


# ------------------------------------------------------ the scheduler


def small_models():
    rgb = factory.init_weights(BDNet(num_classes=5, os_head=True,
                                     use_edl=True, frame_num=CLIP,
                                     crop_size=CROP), seed=0)
    flow = factory.init_weights(BDNet(in_channels=2, num_classes=5,
                                      os_head=True, use_edl=True,
                                      frame_num=CLIP, crop_size=CROP),
                                seed=1)
    return rgb, flow


def pipeline_kwargs(**kw):
    return dict(dict(clip_length=CLIP, stride=STRIDE, crop_size=CROP,
                     conf_thresh=0.01, top_k=50, use_edl=True,
                     os_head=True, device='cpu'), **kw)


# name: (RGB frames, sample_count, flow frames)
EDGE_VIDEOS = {                  # the first three share one flush
    'shorter_than_clip': (100, 100, 99),        # offsets [0]
    'plain': (200, 200, 199),
    'flow_much_shorter': (180, 180, 130),
    'npy_shorter_than_count': (300, 420, 299),  # tail windows past the npy
    'oversize': (700, 700, 699),                # > frames_capacity alone
}
CAPACITY, BATCH = 512, 4


def edge_videos(seed=5):
    rng = np.random.RandomState(seed)
    return [(name, rng.randint(0, 256, (t, 40, 40, 3), dtype=np.uint8),
             count, 10.0, rng.randint(0, 256, (tf, 40, 40, 2),
                                      dtype=np.uint8))
            for name, (t, count, tf) in EDGE_VIDEOS.items()]


@pytest.fixture(scope='module')
def scheduler_run():
    """The fused packed run over EDGE_VIDEOS with its staging, window
    batches and pool calls recorded, and each video's per-video run."""
    rgb, flow = small_models()
    pipe = InferencePipeline(rgb, flow_model=flow, **pipeline_kwargs())
    videos = edge_videos()
    seen = {'stage': [], 'windows': [], 'pools': 0}
    real_stage, real_windows = pipeline.stage_frames, pipeline.device_windows
    real_pool = pyramid.boundary_max_pool_segmented

    def stage(buf, *a, **kw):
        out = real_stage(buf, *a, **kw)
        seen['stage'].append((tuple(buf.shape), tuple(out.shape)))
        return out

    def windows(video, offs, valid, clip):
        seen['windows'].append((video.shape[-1], offs.clone(),
                                torch.as_tensor(valid).clone()))
        return real_windows(video, offs, valid, clip)

    def pool(*a):
        seen['pools'] += 1
        return real_pool(*a)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pipeline, 'stage_frames', stage)
        mp.setattr(pipeline, 'device_windows', windows)
        mp.setattr(pyramid, 'boundary_max_pool_segmented', pool)
        packed = pipe.run_videos(iter(videos), max_batch=BATCH,
                                 frames_capacity=CAPACITY)
    per_video = {name: pipe.run_video(data, count, fps, flow_data=fl)
                 for name, data, count, fps, fl in videos}
    return seen, packed, per_video


def plan_regions():
    """The flushes the scheduler should make: lists of (name, region)."""
    plans, cur, cursor = [], [], 0
    for name, (t, count, tf) in EDGE_VIDEOS.items():
        region = max(window_offsets(count, CLIP, STRIDE)[-1] + CLIP, t, tf)
        if cur and cursor + region > CAPACITY:
            plans.append(cur)
            cur, cursor = [], 0
        cur.append((name, region))
        cursor += region
    return plans + [cur]


def test_scheduler_flushes_and_pads(scheduler_run):
    """One RGB and one flow buffer per flush, of k x frames_capacity
    frames holding the flush's regions; every forward has max_batch
    windows and the tail rows carry frames-valid 0."""
    seen, packed, _ = scheduler_run
    plans = plan_regions()
    assert len(plans) == 3 and len(plans[0]) == 3
    stages = [s for s in seen['stage']]
    assert len(stages) == 2 * len(plans)
    for (rgb, frgb), (flow, fflow), regions in zip(stages[::2], stages[1::2],
                                                   plans):
        cursor = sum(r for _, r in regions)
        cap = -(-cursor // CAPACITY) * CAPACITY
        assert rgb == (cursor, CROP, CROP, 3) and frgb[0] == cap
        assert flow == (cursor, CROP, CROP, 2) and fflow[0] == cap
    assert max(s[1][0] for s in stages) == 2 * CAPACITY   # the oversize
    n_windows = 0
    for regions in plans:
        n = sum(len(window_offsets(EDGE_VIDEOS[v][1], CLIP, STRIDE))
                for v, _ in regions)
        n_windows += -(-n // BATCH) * BATCH
    rgb_calls = [w for w in seen['windows'] if w[0] == 3]
    assert len(rgb_calls) == len(seen['windows']) // 2
    assert sum(len(o) for _, o, _ in rgb_calls) == n_windows
    assert all(len(o) == BATCH for _, o, _ in rgb_calls)
    assert any((v == 0).any() and (v > 0).any() for _, _, v in rgb_calls)
    assert set(packed) == set(EDGE_VIDEOS)


def test_scheduler_pool_launches(scheduler_run):
    """Each fused forward pools twice per stream (the frame-level pool and
    the packed lr pool)."""
    seen, _, _ = scheduler_run
    forwards = len(seen['windows']) // 2
    assert seen['pools'] == 2 * 2 * forwards


@pytest.mark.parametrize('name', list(EDGE_VIDEOS))
def test_scheduler_edge_case_matches_per_video(scheduler_run, name):
    _, packed, per_video = scheduler_run
    want, got = per_video[name], packed[name]
    assert len(want) > 0
    to_json = [[dict(p, label=p['cls']) for p in ps] for ps in (want, got)]
    assert_same(*to_json)


# ------------------------------------- post-processing one flush behind

# RGB frames of each video (sample count the same, flow a frame shorter);
# at CAPACITY 512 and clip / stride 128 they make four flushes, the third
# of one video: regions 200 + 250, 300 + 150, 480, 140 + 128
BEHIND_LENGTHS = (200, 250, 300, 150, 480, 140, 100)
BEHIND_FLUSHES = [['v0', 'v1'], ['v2', 'v3'], ['v4'], ['v5', 'v6']]
# run: (fusion, videos)
BEHIND_RUNS = {'rgb': (False, 7), 'fusion': (True, 7), 'one_flush': (False, 2)}


@pytest.fixture(scope='module', params=sorted(BEHIND_RUNS))
def behind_run(request):
    """A packed run under `profiling.recording()` with every forward and
    every post-processed video logged in order (`post_process_on_device`
    replaced on the instance, keeping what it returned), and each video's
    per-video run."""
    fusion, n = BEHIND_RUNS[request.param]
    rgb, flow = small_models()
    pipe = InferencePipeline(rgb, flow_model=flow if fusion else None,
                             **pipeline_kwargs())
    rng = np.random.RandomState(11)
    videos = [(f'v{i}', rng.randint(0, 256, (t, 40, 40, 3), np.uint8), t,
               10.0, rng.randint(0, 256, (t - 1, 40, 40, 2), np.uint8))
              for i, t in enumerate(BEHIND_LENGTHS[:n])]
    log, returned = [], []
    real_decode, real_post = pipe.windows_decode, pipe.post_process_on_device

    def decode(*a):
        log.append(('forward', a[-1]))
        return real_decode(*a)

    def post(*a, **kw):
        returned.append(real_post(*a, **kw))
        log.append(('post', len(returned) - 1))
        return returned[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pipe, 'windows_decode', decode)
        mp.setattr(pipe, 'post_process_on_device', post)
        with profiling.recording():
            packed = pipe.run_videos(iter(videos), max_batch=BATCH,
                                     frames_capacity=CAPACITY)
        rec = profiling.recorded()
    per_video = {name: pipe.run_video(data, count, fps,
                                      flow_data=fl if fusion else None)
                 for name, data, count, fps, fl in videos}
    names = [v[0] for v in videos]
    flushes = BEHIND_FLUSHES if n == len(BEHIND_LENGTHS) else [names]
    return dict(names=names, flushes=flushes, packed=packed, rec=rec,
                log=log, returned=returned, per_video=per_video)


def test_behind_matches_per_video(behind_run):
    """Every video's proposals, list for list, equal its per-video
    run's, in the order the videos came."""
    r = behind_run
    assert list(r['packed']) == r['names']
    for name in r['names']:
        want, got = r['per_video'][name], r['packed'][name]
        assert len(want) > 0
        assert_same(*[[dict(p, label=p['cls']) for p in ps]
                      for ps in (want, got)])


def test_posts_run_one_flush_behind(behind_run):
    """The flushes are the planned ones; each flush's videos are
    post-processed after the next flush's forwards were queued and
    before the one after it, the last flush's after every forward."""
    r = behind_run
    plans = [s for s in r['rec'].spans if s.name == 'ingest.plan']
    assert [s.attrs['videos'] for s in plans] == \
        [len(f) for f in r['flushes']]
    log, first, last = r['log'], {}, {}
    for i, (kind, flush) in enumerate(log):
        if kind == 'forward':
            first.setdefault(flush, i)
            last[flush] = i
    n, video = len(r['flushes']), 0
    for k, flush in enumerate(r['flushes']):
        for _ in flush:
            at = log.index(('post', video))
            assert at > last[min(k + 1, n - 1)], (k, log)
            if k + 2 < n:
                assert at < first[k + 2], (k, log)
            video += 1


def test_post_behind_counts_the_windows_hidden(behind_run):
    """`post.behind`: per video, its real windows outside the last
    flush, 0 in it (every count 0 in a single-flush run)."""
    r = behind_run
    counts = [c.n for c in r['rec'].counts if c.name == 'post.behind']
    last = set(r['flushes'][-1])
    want = [0 if name in last else len(window_offsets(
        BEHIND_LENGTHS[int(name[1:])], CLIP, STRIDE)) for name in r['names']]
    assert counts == want
    if len(r['flushes']) == 1:
        assert sum(counts) == 0
    else:
        assert sum(counts) > 0


def test_post_process_on_device_called_once_a_video(behind_run):
    """The instance's `post_process_on_device` runs once per video and
    the list it returns is the one stored in the results."""
    r = behind_run
    assert len(r['returned']) == len(r['names'])
    for name, got in zip(r['names'], r['returned']):
        assert r['packed'][name] is got


def test_device_windows_zero_the_next_videos_frames():
    """Two videos packed back to back: the first one's only window reads
    into the second's frames, which frames-valid zeroes; equal to the
    first video alone in a zero-padded buffer."""
    rng = np.random.RandomState(0)
    a = torch.from_numpy(rng.randint(0, 256, (40, 4, 4, 3), np.uint8))
    b = torch.from_numpy(rng.randint(0, 256, (70, 4, 4, 3), np.uint8))
    packed = torch.cat([a, b])
    alone = torch.cat([a, torch.zeros_like(b)])
    offs = torch.tensor([0, 40, 46])
    valid = torch.tensor([40, 110, 110])
    got = device_windows(packed, offs, valid, 64)
    assert torch.equal(got[0], device_windows(alone, offs[:1], 40, 64)[0])
    assert torch.equal(got[0, :, 40:], torch.zeros_like(got[0, :, 40:]))
    assert torch.equal(got[1:], device_windows(packed, offs[1:], 110, 64))


def test_host_windows_equal_device_windows():
    rng = np.random.RandomState(1)
    data = rng.randint(0, 256, (150, 6, 5, 3), np.uint8)
    offsets = [0, 40, 80, 120]
    want = device_windows(stage_frames(data, pad_to=120 + 64),
                          torch.tensor(offsets), 150, 64)
    host = torch.from_numpy(stack_windows(data, offsets, 64))
    assert torch.equal(host.permute(0, 4, 1, 2, 3), want)
    clips, valid = stack_windows_u8(data, offsets, 64)
    assert valid.tolist() == [64, 64, 64, 30]
    assert torch.equal(ingest_windows(torch.from_numpy(clips),
                                      torch.from_numpy(valid)), want)


def test_stage_frames_chunked_equals_monolithic():
    """`chunk_frames` (the JAX signature's chunk size) is a hint: any
    value stages the same padded buffer as one copy."""
    rng = np.random.RandomState(0)
    buf = rng.randint(0, 255, (350, 4, 5, 3), np.uint8)
    for pad_to in (None, 350, 512):
        want = stage_frames(buf, None, pad_to=pad_to)
        assert want.shape[0] == (pad_to or 350)
        assert torch.equal(want[:350], torch.from_numpy(buf))
        assert not want[350:].any()
        for ck in (1, 1024):
            assert torch.equal(stage_frames(buf, ck, pad_to=pad_to), want)
            assert torch.equal(stage_frames(torch.from_numpy(buf), ck,
                                            pad_to=pad_to), want)
    with pytest.raises(ValueError, match='pad_to'):
        stage_frames(buf, pad_to=349)


def test_device_nms_matches_host_nms():
    """device_nms=True (each class's block padded to a power of two >=
    64 through `soft_nms_device`) keeps the same rows as the numpy
    soft-NMS."""
    model = BDNet(num_classes=5, os_head=True, use_edl=True,
                  frame_num=CLIP, crop_size=CROP)
    kw = pipeline_kwargs(device_post=False)
    host = InferencePipeline(model, **kw)
    dev = InferencePipeline(model, device_nms=True, **kw)
    rng = np.random.RandomState(3)
    for w in (1, 3, 9):
        start = rng.uniform(0, 20, (w, 40, 1)).astype(np.float32)
        seconds = np.concatenate(
            [start, start + rng.uniform(0.5, 6, (w, 40, 1))], -1
        ).astype(np.float32)
        conf = rng.uniform(0, 0.3, (w, 40, 5)).astype(np.float32)
        unct = rng.uniform(0, 1, (w, 40)).astype(np.float32)
        act = rng.uniform(0.3, 1, (w, 40)).astype(np.float32)
        want = host.post_process(seconds, conf, unct, act)
        got = dev.post_process(seconds, conf, unct, act)
        assert len(want) > 10
        assert len(got) == len(want)
        for a, b in zip(want, got):
            assert a['cls'] == b['cls']
            np.testing.assert_allclose(a['score'], b['score'], rtol=1e-5)
            assert a['segment'] == b['segment']
            assert a['uncertainty'] == b['uncertainty']
            assert a['actionness'] == b['actionness']


def test_float_frames_are_refused():
    model = BDNet(num_classes=5, os_head=True, use_edl=True,
                  frame_num=CLIP, crop_size=CROP)
    video = np.zeros((130, 40, 40, 3), np.float32)
    for ingest in (True, False):
        pipe = InferencePipeline(model, device_ingest=ingest,
                                 **pipeline_kwargs())
        with pytest.raises(TypeError, match='uint8'):
            pipe.run_video(video, 130, 10.0)
        with pytest.raises(TypeError, match='uint8'):
            pipe.run_videos(iter([('v', video, 130, 10.0)]))


def test_fusion_needs_flow_frames():
    rgb, flow = small_models()
    fused = InferencePipeline(rgb, flow_model=flow, **pipeline_kwargs())
    video = np.zeros((130, 40, 40, 3), np.uint8)
    with pytest.raises(ValueError, match='flow'):
        fused.run_video(video, 130, 10.0)
    with pytest.raises(ValueError, match='flow'):
        InferencePipeline(rgb, **pipeline_kwargs()).run_video(
            video, 130, 10.0, flow_data=video[..., :2])


# -------------------------------------------- the CLI's keys (C1 / C2)


def test_shared_backbone_is_refused(dataset):
    """C1, closed: `testing.shared_backbone` is no longer refused; the
    CLI builds the shared-backbone pipeline (its results are held
    against JAX's in `tests/test_torch_shared_backbone.py`)."""
    _, cfg_path, overrides = dataset
    pipe, _, _ = port_test.build_pipeline(load_config(cfg_path, overrides=dict(
        overrides, **{'testing.shared_backbone': True})), device='cpu')
    assert pipe.shared_backbone and pipe.flow_model is not None


def test_cli_reads_the_packing_keys(dataset, monkeypatch):
    """run_test hands `testing.packed_batch` and `packed_frames(te)` to
    run_videos, runs per video with `testing.packed: false`, and builds
    the pipeline with `testing.device_ingest` and `testing.device_nms`;
    `packed_frames` equals the JAX CLI's."""
    _, cfg_path, overrides = dataset
    calls = []

    def run_videos(self, videos, **kw):
        calls.append(('packed', self.device_ingest, kw))
        return {item[0]: [] for item in videos}

    monkeypatch.setattr(InferencePipeline, 'run_videos', run_videos)
    monkeypatch.setattr(InferencePipeline, 'run_video',
                        lambda self, *a, **kw: calls.append(
                            ('per_video', self.device_ingest, {})) or [])
    for extra in ({}, {'testing.device_ingest': False},
                  {'testing.packed_frames': 1000,
                   'testing.packed_batch': 16},
                  {'testing.packed': False}):
        cfg = load_config(cfg_path, overrides=dict(overrides, **extra))
        port_test.run_test(cfg, device='cpu')
    assert calls[0] == ('packed', True, {'max_batch': 4,
                                         'frames_capacity': 512})
    assert calls[1] == ('packed', False, {'max_batch': 4,
                                          'frames_capacity': 512})
    assert calls[2] == ('packed', True, {'max_batch': 16,
                                         'frames_capacity': 1000})
    assert [c[0] for c in calls[3:]] == ['per_video'] * 3
    for te in ({}, {'device_ingest': False}, {'device_ingest': True},
               {'packed_frames': 77, 'device_ingest': False}):
        assert port_test.packed_frames(te) == jax_test.packed_frames(te)
    pipe, _, _ = port_test.build_pipeline(load_config(
        cfg_path, overrides=dict(overrides, **{'testing.device_nms': False})),
        device='cpu')
    assert not pipe.device_post and pipe.flow_model is not None
    assert pipe.flow_model.backbone._model.Conv3d_1a_7x7.conv3d.weight \
        .shape[1] == 2


def test_factory_same_model_for_trunk_tfold_and_remat(dataset):
    """`model.trunk_tfold` and `model.remat` select formulations of the
    same math in the JAX package: the port builds the same model."""
    _, cfg_path, _ = dataset
    base = factory.build_model(load_config(cfg_path), frame_num=CLIP,
                               crop_size=CROP)
    other = factory.build_model(load_config(cfg_path, overrides={
        'model.trunk_tfold': True, 'model.remat': True}), frame_num=CLIP,
        crop_size=CROP)
    want = {k: v.shape for k, v in base.state_dict().items()}
    assert {k: v.shape for k, v in other.state_dict().items()} == want
    other.load_state_dict(base.state_dict())
    x = torch.from_numpy(np.random.RandomState(0).uniform(
        -1, 1, (1, 3, CLIP, CROP, CROP)).astype(np.float32))
    with torch.no_grad():
        a, b = base.eval()(x), other.eval()(x)
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
