"""The port's offline preprocessing (`opental_torch/data/preprocess.py` and
the `video2npy` / `flow2npy` / `anet_info` subcommands of
`tools.preprocess`) against the JAX package's.

The decode cases write small mp4s with OpenCV (`mp4v`) and skip where
OpenCV is missing; the npys must be equal byte for byte and the video
info CSVs equal. Without OpenCV's contrib `optflow` module both packages
refuse TVL1 flow with a RuntimeError.
"""

import itertools
import sys

import numpy as np
import pytest

from torch_suite import suite_policy  # noqa: F401 (autouse)

from opental_tpu.data import preprocess as jax_pp
from opental_tpu.tools import preprocess as jax_cli

from opental_torch.data import preprocess as pp
from opental_torch.tools import preprocess as cli

# fps, frames, size: non-integer fps ratios and a source slower than the
# sample rate (kept whole)
VIDEOS = {'vid_a': (30.0, 31, (48, 40)), 'vid_b': (25.0, 23, (36, 52)),
          'vid_c': (7.0, 9, (40, 40))}


def test_resample_indices_match_jax():
    fps = (30.0, 29.97, 25.0, 24.0, 23.976, 10.0, 7.5, 60.0)
    sample = (10.0, 3.0, 7.5, 30.0)
    for f, s, n in itertools.product(fps, sample, (0, 1, 17, 301)):
        got = pp.resample_indices_stream(f, s, n)
        want = jax_pp.resample_indices_stream(f, s, n)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=str((f, s, n)))


def test_require_cv2_matches_jax(monkeypatch):
    cv2 = pytest.importorskip('cv2')
    assert pp._require_cv2() is jax_pp._require_cv2() is cv2
    monkeypatch.setitem(sys.modules, 'cv2', None)
    for mod in (pp, jax_pp):
        with pytest.raises(RuntimeError, match='opencv is required'):
            mod._require_cv2()


def write_videos(root):
    cv2 = pytest.importorskip('cv2')
    root.mkdir(parents=True)
    rng = np.random.RandomState(0)
    for name, (fps, n, (w, h)) in VIDEOS.items():
        out = cv2.VideoWriter(str(root / f'{name}.mp4'),
                              cv2.VideoWriter_fourcc(*'mp4v'), fps, (w, h))
        assert out.isOpened()
        base = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        for i in range(n):
            out.write(np.roll(base, 3 * i, axis=1))
        out.release()
    return root


@pytest.fixture(scope='module')
def videos(tmp_path_factory):
    """The mp4s, with OpenCV on one thread while this module runs: JAX's
    `videos_to_npy` forks its workers, and a forked child must not inherit
    a lock of OpenCV's thread pool (results do not depend on the count)."""
    cv2 = pytest.importorskip('cv2')
    threads = cv2.getNumThreads()
    cv2.setNumThreads(0)
    try:
        yield write_videos(tmp_path_factory.mktemp('preprocess') / 'mp4')
    finally:
        cv2.setNumThreads(threads)


def test_video_to_npy_matches_jax(videos, tmp_path):
    for name, (fps, n, _) in VIDEOS.items():
        src = str(videos / f'{name}.mp4')
        for max_frames in (None, 4):
            got = pp.video_to_npy(src, str(tmp_path / 'p.npy'), 7.5, 24,
                                  max_frames)
            want = jax_pp.video_to_npy(src, str(tmp_path / 'j.npy'), 7.5,
                                       24, max_frames)
            assert got == want
            assert got[0] == pytest.approx(fps) and got[2] >= 1
            assert ((tmp_path / 'p.npy').read_bytes()
                    == (tmp_path / 'j.npy').read_bytes())
            arr = np.load(tmp_path / 'p.npy')
            assert arr.shape == (got[2], 24, 24, 3) and arr.dtype == np.uint8
    with pytest.raises(IOError):
        pp.video_to_npy(str(tmp_path / 'none.mp4'), str(tmp_path / 'x.npy'))


@pytest.mark.parametrize('workers', [1, 2])
def test_videos_to_npy_matches_jax(videos, tmp_path, workers):
    """Both branches (in process, and the process pool) with the video
    info CSV; the CLI's video2npy runs the same with equal files out."""
    names = sorted(VIDEOS)
    for tag, mod in (('port', pp), ('jax', jax_pp)):
        mod.videos_to_npy(str(videos), str(tmp_path / tag), names,
                          sample_fps=10.0, resolution=16,
                          video_info_csv=str(tmp_path / f'{tag}.csv'),
                          workers=workers)
    for tag, mod in (('port_cli', cli), ('jax_cli', jax_cli)):
        mod.main(['video2npy', '--video_dir', str(videos), '--output_dir',
                  str(tmp_path / tag), '--workers', str(workers),
                  '--resolution', '16', '--max_frames', '5',
                  '--video_info_csv', str(tmp_path / f'{tag}.csv')])
    for a, b in (('jax', 'port'), ('jax_cli', 'port_cli')):
        assert ((tmp_path / f'{a}.csv').read_text()
                == (tmp_path / f'{b}.csv').read_text())
        for name in names:
            assert ((tmp_path / a / f'{name}.npy').read_bytes()
                    == (tmp_path / b / f'{name}.npy').read_bytes()), name
    rows = (tmp_path / 'port.csv').read_text().splitlines()
    assert rows[0] == 'video,fps,sample_fps,count,sample_count'
    assert [r.split(',')[0] for r in rows[1:]] == names
    # a source slower than the sample rate keeps every frame
    assert rows[3].split(',')[3:] == ['9', '9']


def test_flow_is_refused_without_optflow(tmp_path):
    """No TVL1 without OpenCV's contrib module: both packages raise,
    through the library and the CLI."""
    cv2 = pytest.importorskip('cv2')
    if hasattr(cv2, 'optflow'):
        pytest.skip('this OpenCV has the contrib optflow module')
    rgb = tmp_path / 'rgb.npy'
    np.save(rgb, np.zeros((3, 8, 8, 3), np.uint8))
    for mod, main in ((pp, cli.main), (jax_pp, jax_cli.main)):
        with pytest.raises(RuntimeError, match='optflow'):
            mod.flow_to_npy(str(rgb), str(tmp_path / 'f.npy'))
        with pytest.raises(RuntimeError, match='optflow'):
            main(['flow2npy', '--rgb_npy', str(rgb),
                  '--out_npy', str(tmp_path / 'f.npy')])
    assert not (tmp_path / 'f.npy').exists()


def test_anet_video_info_matches_jax(tmp_path):
    import json
    npy = tmp_path / 'npy'
    npy.mkdir()
    for name, t in (('v_a1', 90), ('v_b2', 768), ('v_c3', 17)):
        np.save(npy / f'{name}.npy', np.zeros((t, 2, 2, 3), np.uint8))
    db = {'database': {
        'a1': {'subset': 'training', 'duration': 30.5, 'annotations': [
            {'label': 'Run', 'label_id': 2, 'segment': [1.0, 4.5]},
            {'label': 'Jump', 'segment': [10.0, 12.0]}]},
        'v_b2': {'subset': 'validation', 'duration': 200.0,
                 'annotations': [{'label': 'Run', 'segment': [3.0, 9.0]}]},
        'c3': {'subset': 'testing', 'duration': 3.0, 'annotations': []},
        'd4': {'subset': 'training', 'duration': 3.0, 'annotations': []}}}
    (tmp_path / 'db.json').write_text(json.dumps(db))
    for tag, mod in (('port', pp), ('jax', jax_pp)):
        mod.anet_video_info(str(npy), str(tmp_path / 'db.json'),
                            str(tmp_path / f'{tag}.json'))
    got = (tmp_path / 'port.json').read_bytes()
    assert got == (tmp_path / 'jax.json').read_bytes()
    info = json.loads(got)
    assert sorted(info) == ['v_a1', 'v_b2', 'v_c3']
    assert info['v_b2']['frame_num'] == 768
    assert info['v_a1']['annotations'][1]['label_id'] == 0
