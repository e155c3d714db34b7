"""The port's evaluator and its open-set tools vs the JAX package's, on
the CPU.

  * `opental_torch.eval.detection` (numpy ranking metrics in place of
    scikit-learn's) gives exactly JAX's mAP, AUC-ROC / AUC-PR / FAR@95,
    OSDR and WI on the same JSONs, and `eval.metrics` exactly
    scikit-learn's curves and scores;
  * `tools.eval_open` writes the same eval(_open).txt files and prints
    the same summary as JAX's CLI;
  * `tools.test_cross_data`: the merged THUMOS + ActivityNet JSON
    against JAX's `run_cross_data` per proposal (synthetic THUMOS and
    ANet sets, seeded port weights), and its per-pass idempotence;
  * `tools.search_param`: the cache manifest (the checkpoint
    fingerprint) and each candidate's average mAP of a 2 x 2 grid
    against JAX's; the cache is re-read, emptied for other weights, and
    a cache with no manifest counts as stale.
"""

import json
import os
import warnings

import numpy as np
import pytest
import sklearn.metrics as skm
import torch

from proposal_matching import assert_proposal_parity
from test_torch_packed_inference import cli_config, eval_shape_variables
from torch_suite import suite_policy  # noqa: F401 (autouse)

from opental_tpu.config import load_config as jax_load_config
from opental_tpu.eval.detection import DetectionEvaluator as JEvaluator
from opental_tpu.tools import eval_open as jax_eval_open
from opental_tpu.tools import search_param as jax_sp
from opental_tpu.tools import test as jax_test
from opental_tpu.tools import test_cross_data as jax_cross
from opental_tpu.utils.synthetic import (make_synthetic_anet_dataset,
                                         make_synthetic_dataset)

from opental_torch import factory
from opental_torch.config import load_config
from opental_torch.eval import metrics
from opental_torch.eval.detection import DetectionEvaluator
from opental_torch.tools import eval_open
from opental_torch.tools import search_param as sp
from opental_torch.tools import test_cross_data as cross

CLIP, CROP = 128, 32
CLASSES = ['Run', 'Jump', 'Swim']
SMALL = {'model.compute_dtype': 'float32', 'testing.packed_batch': 4,
         'testing.packed_frames': 512}


def make_jsons(root, seed=0, n_videos=6, openset=True):
    """(GT JSON, prediction JSON, class file) of random segments."""
    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    cls = os.path.join(root, 'Class_Index_Known.txt')
    with open(cls, 'w') as f:
        f.write(''.join(f'{i + 1} {c}\n' for i, c in enumerate(CLASSES)))
    database, results = {}, {}
    for v in range(n_videos):
        vid = f'video_{v:03d}'
        anns = []
        for _ in range(rng.randint(2, 5)):
            s = rng.uniform(0, 80)
            label = ('UnknownAction' if openset and rng.rand() < 0.3
                     else CLASSES[rng.randint(len(CLASSES))])
            anns.append({'segment': [s, s + rng.uniform(2, 15)],
                         'label': label})
        database[vid] = {'subset': 'test', 'annotations': anns}
        props = []
        for _ in range(rng.randint(5, 15)):
            s = rng.uniform(0, 80)
            props.append({'label': CLASSES[rng.randint(len(CLASSES))],
                          'score': float(rng.uniform(0.01, 1)),
                          'segment': [float(s),
                                      float(s + rng.uniform(2, 15))],
                          'uncertainty': float(rng.uniform(0, 1)),
                          'actionness': float(rng.uniform(0, 1))})
        results[vid] = props
    gt, pred = os.path.join(root, 'gt.json'), os.path.join(root,
                                                           'pred.json')
    with open(gt, 'w') as f:
        json.dump({'database': database}, f)
    with open(pred, 'w') as f:
        json.dump({'version': 'THUMOS14', 'results': results,
                   'external_data': {}}, f)
    return gt, pred, cls


@pytest.mark.parametrize('scoring', ['uncertainty', 'confidence',
                                     'half_au'])
@pytest.mark.parametrize('seed', [0, 1])
def test_evaluator_equals_jax(tmp_path, seed, scoring):
    gt, pred, cls = make_jsons(str(tmp_path), seed=seed)
    tious = np.array([0.3, 0.5, 0.7])
    out = []
    for ev_cls in (DetectionEvaluator, JEvaluator):
        ev = ev_cls(gt, pred, cls, tiou_thresholds=tious,
                    ood_scoring=scoring, subset=['test'], openset=True)
        got = list(ev.evaluate('AP'))
        ev.pre_evaluate()
        got += list(ev.evaluate('AUC')) + [ev.evaluate('OSDR')]
        got += list(ev.evaluate('WI'))
        out.append(got)
    for a, b in zip(*out):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    gt, pred, cls = make_jsons(str(tmp_path / 'closed'), seed=seed,
                               openset=False)
    closed = [ev_cls(gt, pred, cls, tiou_thresholds=tious, subset=['test'],
                     openset=False).evaluate('AP')
              for ev_cls in (DetectionEvaluator, JEvaluator)]
    for a, b in zip(*closed):
        assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize('case', ['mixed', 'ties', 'all_neg', 'all_pos'])
def test_metrics_equal_sklearn(case):
    rng = np.random.RandomState(len(case))
    y = rng.randint(0, 2, 200)
    s = rng.rand(200)
    if case == 'ties':
        s = np.round(s, 1)
    elif case == 'all_neg':
        y[:] = 0
    elif case == 'all_pos':
        y[:] = 1
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        for name in ('roc_curve', 'precision_recall_curve'):
            for a, b in zip(getattr(metrics, name)(y, s, pos_label=1),
                            getattr(skm, name)(y, s, pos_label=1)):
                assert np.array_equal(a, b, equal_nan=True), name
        ap = metrics.average_precision_score(y, s)
        assert repr(ap) == repr(skm.average_precision_score(y, s))
        if case in ('mixed', 'ties'):
            assert metrics.roc_auc_score(y, s) == skm.roc_auc_score(y, s)
        else:
            with pytest.raises(ValueError):
                metrics.roc_auc_score(y, s)


@pytest.mark.parametrize('open_set', [False, True])
def test_eval_open_cli_equals_jax(tmp_path, capsys, open_set):
    """Two splits of the reference's {id:d} templating: the same
    eval(_open).txt per split and the same printed summary."""
    outs = {}
    for tag, cli in (('jax', jax_eval_open), ('port', eval_open)):
        for s in (0, 1):
            gt, pred, cls = make_jsons(str(tmp_path / tag / f'{s}'), seed=s,
                                       openset=open_set)
        tpl = str(tmp_path / tag / '{id:d}')
        args = [os.path.join(tpl, 'pred.json'),
                os.path.join(tpl, 'gt.json') if not open_set else gt,
                '--cls_idx_known', os.path.join(tpl,
                                                'Class_Index_Known.txt'),
                '--all_splits', '0', '1']
        cli.main(args + (['--open_set', '--ood_scoring', 'uncertainty']
                         if open_set else []))
        name = 'eval_open.txt' if open_set else 'eval.txt'
        files = []
        for s in (0, 1):
            with open(tmp_path / tag / f'{s}' / name) as f:
                files.append(f.read())
        outs[tag] = (files, capsys.readouterr().out)
    assert outs['port'] == outs['jax']
    assert ('Average AUC_ROC' if open_set else 'Average mAP') \
        in outs['port'][1]


# ------------------------------------------ the tools that run the network


@pytest.fixture(scope='module')
def network_data(tmp_path_factory):
    """(root, THUMOS config path, ANet dirs, overlap file) with seeded
    port weights at testing.checkpoint_path."""
    root = str(tmp_path_factory.mktemp('tools'))
    cfg_path = make_synthetic_dataset(os.path.join(root, 'thumos'),
                                      n_train=1, n_test=2, clip_length=CLIP,
                                      crop_size=CROP, temporal_ramp=True,
                                      ensure_class_coverage=True)
    anet_root = os.path.join(root, 'anet')
    make_synthetic_anet_dataset(anet_root, clip_length=256, crop_size=CROP,
                                spatial=40, n_val=3)
    model = factory.init_weights(factory.build_model(
        load_config(cfg_path), frame_num=CLIP, crop_size=CROP), seed=1)
    ckpt = os.path.join(root, 'weights.ckpt')
    torch.save(model.state_dict(), ckpt)
    overlap = os.path.join(root, 'overlapping.txt')
    with open(overlap, 'w') as f:
        f.write('Act01\n')
    # the closed-set GT of search_param's mAP: the known classes only
    anno = os.path.join(root, 'thumos', 'annotations')
    with open(os.path.join(anno, 'Class_Index_Known.txt')) as f:
        known = {ln.split()[1] for ln in f if ln.strip()}
    with open(os.path.join(anno, 'gt_open.json')) as f:
        db = json.load(f)['database']
    with open(os.path.join(anno, 'gt_closed.json'), 'w') as f:
        json.dump({'database': {v: dict(d, annotations=[
            a for a in d['annotations'] if a['label'] in known])
            for v, d in db.items()}}, f)
    cfg_path = cli_config(cfg_path, dict(SMALL, **{
        'testing.checkpoint_path': ckpt}), os.path.join(root, 'cfg.yaml'))
    anet = (os.path.join(anet_root, 'annotations', 'video_info.json'),
            os.path.join(anet_root, 'npy'))
    return root, cfg_path, anet, overlap


@pytest.fixture(scope='module')
def jax_pipeline(network_data):
    """JAX's pipeline of the tools' config, built once (both tools call
    build_pipeline)."""
    _, cfg_path, _, _ = network_data
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_test, 'load_variables', eval_shape_variables)
        return jax_test.build_pipeline(jax_load_config(cfg_path))


@pytest.fixture(scope='module')
def cross_runs(network_data, jax_pipeline):
    root, cfg_path, (info, npy), overlap = network_data
    paths = {}
    for tag in ('jax', 'port'):
        ov = {'testing.output_path': os.path.join(root, f'cross_{tag}')}
        if tag == 'jax':
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(jax_cross, 'build_pipeline',
                           lambda cfg: jax_pipeline)
                paths[tag] = jax_cross.run_cross_data(
                    jax_load_config(cfg_path, overrides=ov), info, npy,
                    overlap)
        else:
            paths[tag] = cross.run_cross_data(
                load_config(cfg_path, overrides=ov), info, npy, overlap,
                device='cpu')
    return paths


def test_cross_data_json_matches_jax(cross_runs, network_data):
    _, _, (info, _), _ = network_data
    with open(cross_runs['jax']) as f:
        want = json.load(f)
    with open(cross_runs['port']) as f:
        got = json.load(f)
    assert_proposal_parity(want, got, min_total=50)
    with open(info) as f:
        infos = json.load(f)
    anet = {k[2:] for k, v in infos.items() if v['subset'] == 'validation'
            and not any(a['label'] == 'Act01' for a in v['annotations'])}
    assert {k for k in got['results'] if k.startswith('validation')} == anet
    assert sum(k.startswith('test_video') for k in got['results']) == 2


def test_cross_data_reads_its_passes_back(cross_runs, network_data,
                                          monkeypatch):
    """A second run reuses both per-pass JSONs: no video is run."""
    root, cfg_path, (info, npy), overlap = network_data
    out = os.path.dirname(cross_runs['port'])
    mtimes = {f: os.path.getmtime(os.path.join(out, f))
              for f in ('thumos14_open_rgb.json', 'anet_open_rgb.json')}
    monkeypatch.setattr(cross, 'infer_videos', None)
    path = cross.run_cross_data(load_config(cfg_path, overrides={
        'testing.output_path': out}), info, npy, overlap, device='cpu')
    assert {f: os.path.getmtime(os.path.join(out, f))
            for f in mtimes} == mtimes
    with open(path) as f, open(cross_runs['port']) as g:
        assert json.load(f) == json.load(g)


def test_exclude_overlapping_equals_jax(tmp_path):
    infos = {'v_a': {'annotations': [{'label': 'X'}]},
             'b': {'annotations': [{'label': 'Y'}]},
             'v_c': {'annotations': []}}
    path = str(tmp_path / 'o.txt')
    with open(path, 'w') as f:
        f.write('X\n\n')
    results = {'a': [1], 'b': [2], 'c': [3], 'd': [4]}
    got = cross.exclude_overlapping(results, infos, path)
    assert got == jax_cross.exclude_overlapping(results, infos, path)
    assert got == {'b': [2], 'c': [3], 'd': [4]}


GRID = [(0.3, None), (0.7, None), (0.3, 0.005), (0.7, 0.005)]


def proposals_as_gt(pred_path, gt_path, every=7):
    """A GT JSON of every `every`-th proposal (by score, per video and
    class) of a detection JSON: seeded weights detect nothing of the
    synthetic GT, and a metric of 0 would hold nothing."""
    with open(pred_path) as f:
        results = json.load(f)['results']
    db = {}
    for vid, props in results.items():
        anns = []
        for label in sorted({p['label'] for p in props}):
            ranked = sorted((p for p in props if p['label'] == label),
                            key=lambda p: -p['score'])
            anns += [{'segment': p['segment'], 'label': label}
                     for p in ranked[::every]]
        db[vid] = {'subset': 'test', 'annotations': anns}
    with open(gt_path, 'w') as f:
        json.dump({'database': db}, f)
    return gt_path


@pytest.fixture(scope='module')
def search_runs(network_data, jax_pipeline):
    """Both packages' raw caches and the 2 x 2 grid's average mAPs
    (sigma 0.3 / 0.7, conf_thresh default / 0.005), against a GT taken
    from the port's sigma 0.5 proposals."""
    root, cfg_path, _, _ = network_data
    closed = os.path.join(root, 'thumos', 'annotations', 'gt_closed.json')
    out = {}
    for tag in ('port', 'jax'):
        work = os.path.join(root, f'search_{tag}')
        cache = os.path.join(work, 'raw_cache')
        if tag == 'jax':
            cfg = jax_load_config(cfg_path)
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(jax_sp, '_cached_pipeline',
                           lambda c: jax_pipeline)
                names = jax_sp.cache_raw_outputs(cfg, cache)
                maps = [jax_sp.evaluate_candidate(cfg, cache, names, gt,
                                                  work, s, conf_thresh=ct)
                        for s, ct in GRID]
        else:
            cfg = load_config(cfg_path)
            names = sp.cache_raw_outputs(cfg, cache, device='cpu')
            sp.evaluate_candidate(cfg, cache, names, closed, work, 0.5,
                                  device='cpu')
            gt = proposals_as_gt(os.path.join(work,
                                              'search_sigma_0.50.json'),
                                 os.path.join(root, 'gt_search.json'))
            maps = [sp.evaluate_candidate(cfg, cache, names, gt, work, s,
                                          conf_thresh=ct, device='cpu')
                    for s, ct in GRID]
        out[tag] = (cfg, cache, names, maps, gt)
    return out


def test_search_param_manifest_equals_jax(search_runs):
    manifests = []
    for tag in ('jax', 'port'):
        with open(os.path.join(search_runs[tag][1], 'manifest.json')) as f:
            manifests.append(json.load(f))
    assert manifests[0] == manifests[1]
    assert manifests[1]['checkpoint'].endswith(
        '@' + str(os.path.getmtime(manifests[1]['checkpoint'].rsplit(
            '@', 1)[0])))


def test_search_param_candidates_equal_jax(search_runs):
    want, got = search_runs['jax'][3], search_runs['port'][3]
    assert search_runs['port'][2] == search_runs['jax'][2]
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert min(got) > 0 and len(set(np.round(got, 6))) > 1


def test_search_param_cache_is_reread(search_runs, monkeypatch):
    """The cache of the same weights is read back (the network does not
    run again), and the candidate repeats its metric."""
    cfg, cache, names, maps, gt = search_runs['port']
    before = {f: os.path.getmtime(os.path.join(cache, f))
              for f in os.listdir(cache) if f.endswith('.npz')}
    assert len(before) == len(names)
    pipe = sp._cached_pipeline(cfg, 'cpu')[0]
    monkeypatch.setattr(pipe, 'model', None)
    assert sp.cache_raw_outputs(cfg, cache, device='cpu') == names
    assert {f: os.path.getmtime(os.path.join(cache, f))
            for f in before} == before
    work = os.path.dirname(cache)
    s, ct = GRID[1]
    assert sp.evaluate_candidate(cfg, cache, names, gt, work, s,
                                 conf_thresh=ct, device='cpu') == maps[1]


def test_sync_cache_manifest_staleness(tmp_path):
    """Other weights empty the cache; so does a cache with npz entries
    and no manifest (its weights are unknown); the same weights keep
    it."""
    cache = str(tmp_path / 'raw_cache')
    os.makedirs(cache)

    def npzs():
        return sorted(f for f in os.listdir(cache) if f.endswith('.npz'))

    np.savez(os.path.join(cache, 'legacy.npz'), x=np.zeros(2))
    sp.sync_cache_manifest(cache, 'ckpt@1.0')
    assert npzs() == []
    np.savez(os.path.join(cache, 'a.npz'), x=np.zeros(2))
    sp.sync_cache_manifest(cache, 'ckpt@1.0')
    assert npzs() == ['a.npz']
    sp.sync_cache_manifest(cache, 'ckpt@2.0')
    assert npzs() == []
    with open(os.path.join(cache, 'manifest.json')) as f:
        assert json.load(f) == {'checkpoint': 'ckpt@2.0'}
