"""The port's visualization and download tools against the JAX package's.

  * `tools.visualize`: `read_threshold`, `_segment_iou`,
    `match_preds_with_gt` and `search_video_thresholds` give JAX's
    results on the same JSONs; `timeline_figure`, `action_bar_figure`
    and `main` write their PNGs.
  * `data.download` and `tools.download`: driven only through a stub
    downloader binary that records its calls and fabricates the output
    files (no network); both packages make the same calls, retries
    included, and report the same statuses.
"""

import json
import os
import stat

import numpy as np
import pytest

from torch_suite import suite_policy  # noqa: F401 (autouse)

from opental_tpu.data import download as jax_data_download
from opental_tpu.tools import download as jax_download
from opental_tpu.tools import visualize as jax_visualize

from opental_torch.data import download as data_download
from opental_torch.tools import download
from opental_torch.tools import visualize

CLASSES = ['Run', 'Jump', 'Swim']


def make_dataset(root, seed=0, n_videos=5):
    """(GT database, predictions by video) of random segments, a third of
    the GT unknown actions, and an exact copy of one GT per video."""
    rng = np.random.RandomState(seed)
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
        results[vid] = [{
            'label': CLASSES[rng.randint(len(CLASSES))],
            'score': float(rng.uniform(0.01, 1)),
            'segment': [float(s := rng.uniform(0, 80)),
                        float(s + rng.uniform(2, 15))],
            'uncertainty': float(rng.uniform(0, 1)),
            'actionness': float(rng.uniform(0, 1)),
        } for _ in range(rng.randint(5, 12))]
        results[vid].append({'label': CLASSES[v % 3], 'score': 0.8,
                             'segment': list(anns[0]['segment']),
                             'uncertainty': 0.3, 'actionness': 0.6})
    gt = os.path.join(root, 'gt.json')
    with open(gt, 'w') as f:
        json.dump({'database': database}, f)
    pred = os.path.join(root, 'pred.json')
    with open(pred, 'w') as f:
        json.dump({'version': 'THUMOS14', 'results': results,
                   'external_data': {'threshold': 0.55}}, f)
    return database, results, gt, pred


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_matching_and_threshold_search_match_jax(tmp_path, seed):
    database, results, _, pred = make_dataset(str(tmp_path), seed=seed)
    assert visualize.read_threshold(pred) == \
        jax_visualize.read_threshold(pred) == 0.55
    for vid, preds in results.items():
        gts = database[vid]['annotations']
        segs = np.array([g['segment'] for g in gts])
        for p in preds:
            np.testing.assert_array_equal(
                visualize._segment_iou(p['segment'], segs),
                jax_visualize._segment_iou(p['segment'], segs))
        for t in (0.05, 0.35, 0.65, 0.95):
            for tiou in (0.1, 0.3, 0.5):
                assert visualize.match_preds_with_gt(
                    preds, gts, unct_thresh=t, tiou=tiou) == \
                    jax_visualize.match_preds_with_gt(
                        preds, gts, unct_thresh=t, tiou=tiou)
    videos = sorted(results) + ['missing_video']
    for tiou in (0.1, 0.3):
        got = visualize.search_video_thresholds(results, database, videos,
                                                tiou=tiou)
        assert got == jax_visualize.search_video_thresholds(
            results, database, videos, tiou=tiou)
        assert all(0.0 < v < 1.0 for v in got.values())


def test_figures_and_cli_write_pngs(tmp_path):
    database, results, gt, pred = make_dataset(str(tmp_path), seed=11)
    video = sorted(results)[0]
    npy = tmp_path / 'npy'
    npy.mkdir()
    np.save(npy / f'{video}.npy',
            np.random.RandomState(0).randint(0, 255, (20, 8, 8, 3),
                                             dtype=np.uint8))
    out = tmp_path / 'figs'
    out.mkdir()
    visualize.timeline_figure(video, results[video],
                              database[video]['annotations'],
                              str(out / 'timeline.png'),
                              ood_threshold={video: 0.5},
                              frames=np.load(npy / f'{video}.npy'))
    visualize.action_bar_figure(video, {'m': results[video]},
                                database[video]['annotations'], 100.0,
                                str(out / 'bars.png'),
                                thresholds={'m': {video: 0.5}})
    visualize.main([pred, gt, '--videos', video, '--out_dir', str(out),
                    '--npy_dir', str(npy), '--ood_threshold', '0.4'])
    visualize.main(['a=' + pred, 'b=' + pred, gt, '--bars', '--videos',
                    video, '--out_dir', str(out), '--thresholds', 'a=0.7',
                    'b=search'])
    visualize.main(['a=' + pred, gt, '--bars', '--videos', video,
                    '--out_dir', str(out / 'calibrated'), '--thresholds',
                    f'a={pred}'])
    for path in (out / 'timeline.png', out / 'bars.png',
                 out / f'{video}.png', out / f'{video}_bars.png',
                 out / 'calibrated' / f'{video}_bars.png'):
        assert path.read_bytes()[:8] == b'\x89PNG\r\n\x1a\n', path
        assert path.stat().st_size > 5000, path


STUB = """#!/usr/bin/env python3
import os, sys
args = sys.argv[1:]
out = args[args.index('-o') + 1]
url = args[-1] if args[-1].startswith('http') else args[0]
vid = url.rsplit('=', 1)[1]
with open(os.environ['STUB_LOG'], 'a') as f:
    f.write(vid + '\\n')
if vid.startswith('bad'):
    sys.exit(1)
open(out, 'wb').write(b'mp4')
"""


def make_stub(tmp_path, monkeypatch):
    """A downloader binary that records the ids it is asked for and
    writes a dummy mp4 (fails for ids starting with 'bad')."""
    stub = tmp_path / 'fake-dl'
    stub.write_text(STUB)
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    log = tmp_path / 'calls.log'
    log.write_text('')
    monkeypatch.setenv('STUB_LOG', str(log))
    return str(stub), log


def test_read_video_ids_match_jax(tmp_path):
    anno = tmp_path / 'a.json'
    anno.write_text(json.dumps({'abcdefghijk': {}, 'zzzzzzzzzzz': {}}))
    nested = tmp_path / 'b.json'
    nested.write_text(json.dumps({'database': {'v_123': {}, 'v_456': {}}}))
    ids = tmp_path / 'ids.txt'
    ids.write_text('one\n\ntwo\n  three  \n')
    for path in (anno, nested, ids):
        got = download.read_video_ids(str(path))
        assert got == jax_download.read_video_ids(str(path)) and got


def test_download_all_and_cli_match_jax(tmp_path, monkeypatch):
    """download_one / download_all (retries, idempotence, parallel jobs)
    and the CLI's report, the port's and JAX's on separate directories:
    the same statuses, files and downloader calls."""
    stub, log = make_stub(tmp_path, monkeypatch)
    ids = ['goodvideo01', 'badvideo001', 'goodvideo02']
    calls, reports = {}, {}
    for tag, mod in (('port', download), ('jax', jax_download)):
        log.write_text('')
        out = tmp_path / tag
        status = mod.download_all(ids, str(out), jobs=2, downloader=stub,
                                  attempts=3)
        again = mod.download_all(ids[:1], str(out), jobs=1,
                                 downloader=stub)
        one = mod.download_one('goodvideo03', str(out), stub, attempts=1)
        calls[tag] = sorted(log.read_text().split())
        anno = tmp_path / 'anno.json'
        anno.write_text(json.dumps({i: {} for i in ids}))
        report = tmp_path / f'{tag}_report.json'
        mod.main([str(anno), str(tmp_path / f'{tag}_cli'), '-n', '2',
                  '--downloader', stub, '--attempts', '2', '--report',
                  str(report)])
        reports[tag] = (status, again, one, sorted(os.listdir(out)),
                        json.loads(report.read_text()))
    assert reports['port'] == reports['jax']
    assert calls['port'] == calls['jax']
    status = {s[0]: s[1:] for s in reports['port'][0]}
    assert status['goodvideo01'] == (True, 'Downloaded')
    assert status['badvideo001'] == (False, 'Fail')
    assert reports['port'][1][0][2] == 'Exists'
    assert calls['port'].count('badvideo001') == 3


def test_data_download_matches_jax(tmp_path, monkeypatch):
    """data.download: the downloader lookup, download_video (existing
    files short-circuit, failures give None) and download_activitynet's
    counts, with the stub found on PATH as yt-dlp."""
    stub, log = make_stub(tmp_path, monkeypatch)
    bin_dir = tmp_path / 'bin'
    bin_dir.mkdir()
    os.symlink(stub, bin_dir / 'yt-dlp')
    monkeypatch.setenv('PATH', str(bin_dir) + os.pathsep
                       + os.environ.get('PATH', ''))
    assert data_download._downloader() == \
        jax_data_download._downloader() == ['yt-dlp']
    db = {'database': {
        'good1': {'subset': 'training'}, 'bad2': {'subset': 'validation'},
        'good3': {'subset': 'testing'}, 'good4': {'subset': 'validation'},
        'good5': {'subset': 'training'}}}
    anno = tmp_path / 'anno.json'
    anno.write_text(json.dumps(db))
    got = {}
    for tag, mod in (('port', data_download), ('jax', jax_data_download)):
        log.write_text('')
        out = tmp_path / tag
        stats = mod.download_activitynet(str(anno), str(out), max_videos=3)
        path = mod.download_video('good1', str(out))
        missing = mod.download_video('bad9', str(out))
        got[tag] = (stats, os.path.basename(path), missing,
                    sorted(os.listdir(out)), log.read_text().split())
    assert got['port'] == got['jax']
    assert got['port'][0] == {'ok': 2, 'failed': 1, 'skipped': 1}
    assert got['port'][2] is None
    monkeypatch.setenv('PATH', str(tmp_path / 'empty'))
    for mod in (data_download, jax_data_download):
        with pytest.raises(RuntimeError, match='yt-dlp'):
            mod._downloader()
