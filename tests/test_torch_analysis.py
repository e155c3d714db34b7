"""The port's analysis suite (`opental_torch/tools/analysis.py`) against
the JAX package's, on the CPU.

  * The host reports (`bucket_distributions`, `correctness_*`,
    `stats_report`, `wi_category_masks` / `_mean_ci` /
    `wi_stats_report`, `plot_gradnorm`, `compare_auc_curves`,
    `ood_bar_comparison`) and their CLI commands, on detection JSONs the
    test writes: equal numbers and tables, and every figure written.
  * The three commands that run the network (`distribution`,
    `actionness`, `per_class`): the port's CLI fills the raw-output
    cache once on the CPU (`--device cpu`, seeded weights on a synthetic
    dataset), and JAX's report functions run directly on that cache (the
    two packages write the same npz keys), so both read the same network
    outputs: equal bucket arrays and tables, and the same figures.
"""

import json
import os
import pickle

import numpy as np
import pytest
import torch

from test_torch_packed_inference import cli_config
from torch_suite import suite_policy  # noqa: F401 (autouse)

from opental_tpu.config import load_config as jax_load_config
from opental_tpu.eval.detection import DetectionEvaluator as JEvaluator
from opental_tpu.tools import analysis as jax_analysis

from opental_torch import factory
from opental_torch.config import load_config
from opental_torch.tools import analysis
from opental_torch.tools import search_param
from opental_torch.utils.synthetic import make_synthetic_dataset

CLASSES = ['Run', 'Jump', 'Swim']
CLIP, CROP = 128, 32


def make_dataset(root, seed=0, n_videos=5):
    """(GT JSON, prediction JSON, class file) of random segments, a third
    of the GT unknown actions."""
    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    class_file = os.path.join(root, 'Class_Index_Known.txt')
    with open(class_file, 'w') as f:
        f.write(''.join(f'{i + 1} {c}\n' for i, c in enumerate(CLASSES)))
    database, results = {}, {}
    for v in range(n_videos):
        vid = f'video_{v:03d}'
        anns = []
        for _ in range(rng.randint(2, 5)):
            s = rng.uniform(0, 80)
            label = ('UnknownAction' if rng.rand() < 0.3
                     else CLASSES[rng.randint(len(CLASSES))])
            anns.append({'segment': [s, s + rng.uniform(2, 15)],
                         'label': label})
        database[vid] = {'subset': 'test', 'annotations': anns}
        results[vid] = []
        for _ in range(rng.randint(5, 12)):
            s = rng.uniform(0, 80)
            results[vid].append({
                'label': CLASSES[rng.randint(len(CLASSES))],
                'score': float(rng.uniform(0.01, 1)),
                'segment': [float(s), float(s + rng.uniform(2, 15))],
                'uncertainty': float(rng.uniform(0, 1)),
                'actionness': float(rng.uniform(0, 1))})
        # an exact copy of a GT segment, so every bucket has members
        results[vid].append({
            'label': CLASSES[v % 3], 'score': 0.9,
            'segment': list(anns[0]['segment']),
            'uncertainty': 0.2, 'actionness': 0.7})
    gt = os.path.join(root, 'gt.json')
    with open(gt, 'w') as f:
        json.dump({'database': database}, f)
    pred = os.path.join(root, 'pred.json')
    with open(pred, 'w') as f:
        json.dump({'version': 'THUMOS14', 'results': results,
                   'external_data': {}}, f)
    return gt, pred, class_file


def assert_nested_equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            assert_nested_equal(a[k], b[k])
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def files_by_name(out_dir):
    return {f: open(os.path.join(out_dir, f), 'rb').read()
            for f in sorted(os.listdir(out_dir))}


def assert_same_outputs(want_dir, got_dir, subset=False):
    """The same files in both directories (with `subset`, every file of
    `want_dir` in `got_dir`); every table (csv / json) equal byte for
    byte and every figure a non-empty PNG."""
    want, got = files_by_name(want_dir), files_by_name(got_dir)
    if subset:
        got = {k: v for k, v in got.items() if k in want}
    assert want and sorted(got) == sorted(want)
    for name, data in got.items():
        if name.endswith('.png'):
            assert data[:8] == b'\x89PNG\r\n\x1a\n' and len(data) > 1000
        else:
            assert data == want[name], name


@pytest.mark.parametrize('scoring', ['uncertainty', 'confidence'])
def test_buckets_match_jax(tmp_path, scoring):
    gt, pred, cls = make_dataset(str(tmp_path))
    for tiou in (0.3, 0.5):
        got = analysis.bucket_distributions(pred, gt, cls, scoring, tiou)
        want = jax_analysis.bucket_distributions(pred, gt, cls, scoring,
                                                 tiou)
        assert got == want
        assert all(len(got['ood_score'][k]) for k in ('known', 'bg'))
        assert_nested_equal(
            analysis.correctness_buckets(pred, gt, cls, scoring, tiou),
            jax_analysis.correctness_buckets(pred, gt, cls, scoring, tiou))


def test_wi_categories_match_jax(tmp_path):
    gt, pred, cls = make_dataset(str(tmp_path), seed=3)
    tious = np.array([0.3, 0.5, 0.7])
    ev = JEvaluator(gt, pred, cls, tiou_thresholds=tious,
                    ood_scoring='uncertainty', subset=['test'],
                    openset=True)
    ev.evaluate('WI')
    for tidx in range(len(tious)):
        got = analysis.wi_category_masks(ev.stats, tidx)
        assert_nested_equal(got, jax_analysis.wi_category_masks(ev.stats,
                                                                tidx))
        assert sum(m.astype(int) for m in got.values()).max() == 1
        for key in ('scores', 'max_tious', 'ood_scores'):
            for c in analysis.WI_CATEGORIES:
                v = np.asarray(ev.stats[key])[got[c]]
                assert analysis._mean_ci(v) == jax_analysis._mean_ci(v)
    assert analysis._mean_ci(np.zeros(0)) == (0.0, 0.0)
    assert analysis.WI_CATEGORIES == jax_analysis.WI_CATEGORIES


def write_curves(root):
    """A metrics JSONL and two pickled ROC / PR curve sets."""
    with open(os.path.join(root, 'metrics.jsonl'), 'w') as f:
        for step in range(1, 30):
            f.write(json.dumps({'step': step, 'grad_norm': 10.0 / step,
                                'loss': 1.0}) + '\n')
        f.write(json.dumps({'step': 30, 'loss': 0.5}) + '\n')
    named = []
    for i, name in enumerate(('a', 'b')):
        x = np.linspace(0, 1, 11)
        data = {'fpr': [x], 'tpr': [x ** (1 + i)], 'recall': [x],
                'precision': [1 - 0.5 * x], 'auc': [0.6 + 0.1 * i]}
        path = os.path.join(root, f'{name}.pkl')
        with open(path, 'wb') as f:
            pickle.dump(data, f)
        named.append(f'{name}={path}')
    return os.path.join(root, 'metrics.jsonl'), named


def run_host_cli(main, out, gt, pred, pred_b, cls, jsonl, named):
    os.makedirs(out)
    main(['scores', pred, gt, '--cls_idx', cls, '--out',
          os.path.join(out, 'score_dist.png')])
    main(['gradnorm', jsonl, '--out', os.path.join(out, 'gradnorm.png')])
    for which in ('roc', 'pr'):
        main(['compare_auc', *named, '--which', which,
              '--out', os.path.join(out, f'auc_{which}.png')])
    main(['correctness', pred, gt, '--cls_idx', cls, '--out_dir', out])
    main(['wi_stats', pred, gt, '--cls_idx', cls, '--out_dir', out,
          '--ood_scoring', 'confidence'])
    main(['stats', f'methodA={pred}', f'methodB={pred_b}', '--gt_json', gt,
          '--cls_idx', cls, '--out_dir', out])


def test_host_commands_match_jax(tmp_path, capsys):
    """Every command of the CLI that reads files only, through both
    packages' `main`: the same files, the tables (correctness_summary
    .json) equal byte for byte, and the same lines printed."""
    gt, pred, cls = make_dataset(str(tmp_path))
    _, pred_b, _ = make_dataset(str(tmp_path / 'b'), seed=1)
    jsonl, named = write_curves(str(tmp_path))
    printed = {}
    for tag, main in (('jax', jax_analysis.main), ('port', analysis.main)):
        run_host_cli(main, str(tmp_path / tag), gt, pred, pred_b, cls,
                     jsonl, named)
        printed[tag] = capsys.readouterr().out.replace(str(tmp_path / tag),
                                                       'OUT')
    assert printed['port'] == printed['jax'] and 'wrote' in printed['port']
    assert_same_outputs(str(tmp_path / 'jax'), str(tmp_path / 'port'))
    names = set(os.listdir(tmp_path / 'port'))
    assert {'stats.png', 'stats_ood_scores.png', 'wi_methodA.png',
            'wi_methodB.png', 'stats_categories.png', 'stats_scores.png',
            'stats_tiou.png', 'stats_ood_scores_categories.png',
            'dist_correctness.png', 'dist_correctness_bg.png',
            'correctness_summary.json', 'gradnorm.png', 'auc_roc.png',
            'auc_pr.png', 'score_dist.png'} == names


def test_ood_bar_comparison_writes(tmp_path):
    gt, pred, cls = make_dataset(str(tmp_path))
    buckets = {'m': analysis.bucket_distributions(pred, gt, cls),
               'empty': {'ood_score': {'known': [], 'unknown': [],
                                       'bg': []}}}
    out = str(tmp_path / 'bars.png')
    analysis.ood_bar_comparison(buckets, out)
    assert os.path.getsize(out) > 1000


# ------------------------------------------ the commands that run the network


def recording(mp, module, render):
    """Patch `module.plot_dist` to record what each figure plots (its file
    name, arrays, colours, labels and axis label), rendering it only with
    `render`. Returns the list the records go to."""
    records, real = [], module.plot_dist

    def plot_dist(out_png, arrays, colors, labels, xlabel='', bins=50):
        records.append((os.path.basename(out_png),
                        [np.asarray(a) for a in arrays], list(colors),
                        list(labels), xlabel))
        if render:
            real(out_png, arrays, colors, labels, xlabel, bins)
    mp.setattr(module, 'plot_dist', plot_dist)
    return records


def assert_same_records(got, want):
    assert [r[0] for r in got] == [r[0] for r in want]
    for g, w in zip(got, want):
        assert g[2:] == w[2:], g[0]
        assert len(g[1]) == len(w[1])
        for a, b in zip(g[1], w[1]):
            np.testing.assert_array_equal(a, b, err_msg=g[0])


@pytest.fixture(scope='module')
def network(tmp_path_factory):
    """A synthetic THUMOS dataset with seeded port weights; the port's
    `distribution` command fills a fresh raw cache on the CPU, then
    `actionness` and `per_class` reread it. Returns (config path, JAX
    config, port config, cache dir, GT, class file, port out dir, the
    network runs counted per command, what each command's figures
    plot)."""
    root = str(tmp_path_factory.mktemp('analysis'))
    cfg_path = make_synthetic_dataset(os.path.join(root, 'thumos'),
                                      n_train=1, n_test=2, clip_length=CLIP,
                                      crop_size=CROP, temporal_ramp=True,
                                      ensure_class_coverage=True)
    model = factory.init_weights(factory.build_model(
        load_config(cfg_path), frame_num=CLIP, crop_size=CROP), seed=1)
    ckpt = os.path.join(root, 'weights.ckpt')
    torch.save(model.state_dict(), ckpt)
    cfg_path = cli_config(cfg_path, {
        'model.compute_dtype': 'float32',
        'testing.checkpoint_path': ckpt,
        'testing.output_path': os.path.join(root, 'output')},
        os.path.join(root, 'cfg.yaml'))
    anno = os.path.join(root, 'thumos', 'annotations')
    gt = os.path.join(anno, 'gt_open.json')
    cls = os.path.join(anno, 'Class_Index_Known.txt')
    cache = os.path.join(root, 'output', 'raw_cache')
    out = os.path.join(root, 'port')
    forwards, plots = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        real = search_param.ingest_windows

        def counted(*args, **kw):
            forwards[cmd] = forwards.get(cmd, 0) + 1
            return real(*args, **kw)
        mp.setattr(search_param, 'ingest_windows', counted)
        for cmd in ('distribution', 'actionness', 'per_class'):
            forwards[cmd] = 0
            with pytest.MonkeyPatch.context() as rec:
                plots[cmd] = recording(rec, analysis, render=True)
                analysis.main([cmd, cfg_path, '--gt_json', gt, '--cls_idx',
                               cls, '--out_dir', out, '--device', 'cpu'])
    return (cfg_path, jax_load_config(cfg_path), load_config(cfg_path),
            cache, gt, cls, out, forwards, plots)


def test_network_commands_fill_the_cache_once(network):
    cfg_path, _, cfg, cache, _, _, _, forwards, _ = network
    names = sorted(f[:-4] for f in os.listdir(cache) if f.endswith('.npz'))
    assert len(names) == 2
    assert forwards['distribution'] >= 2
    assert forwards['actionness'] == forwards['per_class'] == 0
    z = np.load(os.path.join(cache, names[0] + '.npz'))
    assert set(search_param.RAW_KEYS) <= set(z.files)


TARGETS = ['uncertainty', 'actionness', 'confidence',
           'uncertainty_actionness', 'half_au']


@pytest.mark.parametrize('target', TARGETS)
def test_stage_buckets_match_jax(network, target):
    _, jcfg, cfg, cache, gt, cls, _, _, _ = network
    got = analysis.stage_buckets(cfg, cache, gt, cls, target)
    want = jax_analysis.stage_buckets(jcfg, cache, gt, cls, target)
    assert_nested_equal(got, want)
    for stage in ('coarse', 'refined'):
        assert all(np.isfinite(v).all() for v in got[stage].values())
        assert len(got[stage]['known']) and len(got[stage]['background'])
    assert len(got['refined']['known']) <= len(got['coarse']['known'])
    got = analysis.per_class_buckets(cfg, cache, gt, cls, target)
    assert_nested_equal(got, jax_analysis.per_class_buckets(
        jcfg, cache, gt, cls, target))
    assert any(len(v) for v in got['coarse'].values())


def test_network_reports_match_jax(network, tmp_path, monkeypatch):
    """JAX's three report functions on the port's cache: each figure of
    distribution and actionness plots the same arrays (recorded, not
    rendered, on JAX's side), per_class writes the same files with
    per_class_stats.csv equal byte for byte; the port's commands wrote
    every figure."""
    _, jcfg, _, cache, gt, cls, out, _, plots = network
    jax_out = str(tmp_path / 'jax')
    for cmd, report in (('distribution', jax_analysis.distribution_report),
                        ('actionness', jax_analysis.actionness_report)):
        with pytest.MonkeyPatch.context() as mp:
            want = recording(mp, jax_analysis, render=False)
            written = report(jcfg, cache, gt, cls, jax_out)
        assert_same_records(plots[cmd], want)
        assert [os.path.basename(w) for w in written] == \
            [r[0] for r in want]
    jax_analysis.per_class_report(jcfg, cache, gt, cls, jax_out)
    assert_same_outputs(jax_out, out, subset=True)
    assert sorted(os.listdir(out)) == sorted(
        [r[0] for cmd in ('distribution', 'actionness')
         for r in plots[cmd]] + ['dist_coarse_per_class.png',
                                 'dist_refined_per_class.png',
                                 'per_class_stats.csv'])


def test_distribution_with_a_detection_json_matches_jax(network, tmp_path):
    """`--pred_json` adds the final proposal distributions; the cache is
    reread (no network run) and every figure plots what JAX's does."""
    cfg_path, jcfg, _, cache, gt, cls, _, _, _ = network
    _, pred, _ = make_dataset(str(tmp_path / 'preds'))
    with open(gt) as f:
        videos = sorted(json.load(f)['database'])
    with open(pred) as f:
        results = json.load(f)['results']
    with open(pred, 'w') as f:
        json.dump({'results': {v: results[r] for v, r in
                               zip(videos, sorted(results))}}, f)
    with pytest.MonkeyPatch.context() as mp:
        got = recording(mp, analysis, render=True)
        analysis.main(['distribution', cfg_path, '--gt_json', gt,
                       '--cls_idx', cls, '--out_dir', str(tmp_path / 'port'),
                       '--pred_json', pred, '--ood_scoring', 'confidence',
                       '--device', 'cpu'])
    with pytest.MonkeyPatch.context() as mp:
        want = recording(mp, jax_analysis, render=False)
        jax_analysis.distribution_report(jcfg, cache, gt, cls,
                                         str(tmp_path / 'jax'),
                                         target='confidence', pred_json=pred)
    assert_same_records(got, want)
    assert [r[0] for r in got] == ['dist_coarse.png', 'dist_refined.png',
                                   'dist_final.png', 'dist_final_nobg.png']
    assert sorted(os.listdir(tmp_path / 'port')) == sorted(r[0] for r in got)
