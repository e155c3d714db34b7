"""The port's OpenMax baseline vs the JAX package's, on the CPU.

  * libmr: the port compiles `native/libmr/libmr.cpp` with g++ into its
    own build directory (nothing under `native/` is written) and fits
    the same Weibull tails as JAX's binding, to the last bit;
  * `eucos_dist`, `OpenMax.__call__` and the saved MAV / distance files
    at rtol 1e-6; a class with no features is a no-op;
  * `extract_positive_features` (the `get_feat` taps of positively
    matched priors over uint8 training clips) at the out_dict tolerance,
    rtol 1e-3 / atol 2e-3;
  * the three-stage CLI (`python -m opental_torch.tools.test_openmax
    <cfg> --device cpu`) on `configs/thumos14_openmax.yaml`'s model
    (softmax heads, no os_head, no EDL) over a synthetic dataset: its
    MAV files and its detection JSON against JAX's CLI.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch


from proposal_matching import assert_proposal_parity
from test_torch_packed_inference import cli_config, eval_shape_variables
from torch_suite import suite_policy  # noqa: F401 (autouse)

from opental_tpu.models.bdnet import BDNet as JBDNet
from opental_tpu.openset import libmr as jlibmr
from opental_tpu.openset import openmax as jom
from opental_tpu.tools import test_openmax as jax_cli
from opental_tpu.utils.synthetic import make_synthetic_dataset

from opental_torch import factory
from opental_torch.config import load_config
from opental_torch.data.thumos import (ThumosTrainDataset,
                                       get_class_index_map, get_video_anno,
                                       get_video_info)
from opental_torch.models.bdnet import BDNet
from opental_torch.openset import libmr
from opental_torch.openset import openmax as tom
from opental_torch.tools import test_openmax as port_cli
from opental_torch.utils.convert import from_jax_variables

FRAME, CROP = 128, 32
CLOSED_SET = {'model.use_edl': False, 'model.os_head': False,
              'training.edl_loss': False, 'training.focal_loss': True,
              'testing.top_k': 100}


def _tails(seed, n=6):
    rng = np.random.RandomState(seed)
    return [np.sort(np.abs(rng.randn(40) * rng.uniform(0.1, 1.0)
                           + rng.uniform(0.2, 3.0)))[-20:]
            for _ in range(n)]


def _tree_mtimes(path):
    return {os.path.join(d, f): os.stat(os.path.join(d, f)).st_mtime_ns
            for d, _, fs in os.walk(path) for f in fs}


def test_libmr_builds_into_the_port(tmp_path, monkeypatch):
    """Two processes building at once into an empty build directory
    both load a library; nothing under native/ changes."""
    native = os.path.dirname(libmr.SOURCE)
    before = _tree_mtimes(native)
    root = str(tmp_path / '_build')
    code = ('import sys; from opental_torch.openset import libmr; '
            f'libmr.BUILD_ROOT = {root!r}; mr = libmr.MR(); '
            'assert mr.fit_high([1.0, 2.0, 3.0, 4.5, 5.0], 5); '
            'print(libmr.library_path())')
    env = dict(os.environ, PYTHONPATH=os.getcwd())
    procs = [subprocess.Popen([sys.executable, '-c', code], env=env,
                              stdout=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate()[0].strip() for p in procs]
    assert all(p.returncode == 0 for p in procs)
    assert outs[0] == outs[1] and outs[0].startswith(root)
    assert os.listdir(os.path.dirname(outs[0])) == ['libmr.so']
    assert _tree_mtimes(native) == before
    monkeypatch.setattr(libmr, 'BUILD_ROOT', root)
    assert libmr.library_path() == outs[0]


@pytest.mark.parametrize('seed', [0, 1])
def test_libmr_matches_jax(seed):
    for tail in _tails(seed):
        a, b = libmr.MR(), jlibmr.MR()
        assert a.fit_high(tail, len(tail)) == b.fit_high(tail, len(tail))
        assert (a.scale, a.shape, a.small_score) == (b.scale, b.shape,
                                                     b.small_score)
        xs = np.linspace(0, tail.max() * 1.5, 33)
        assert np.array_equal(a.w_score_vector(xs), b.w_score_vector(xs))
        assert a.w_score(xs[7]) == b.w_score(xs[7])
        assert a.inv(0.5) == b.inv(0.5)
        assert libmr.MR.from_dict(a.to_dict()).to_dict() == b.to_dict()
    bad = libmr.MR()
    assert not bad.fit_high([1.0], 1)
    assert not bad.w_score_vector([1.0, 2.0]).any()


def _weibull(mod, rng, names, dim, missing=()):
    model = {}
    for i, name in enumerate(names):
        mr = None
        if name not in missing:
            mr = mod.MR()
            mr.fit_high(_tails(10 + i, 1)[0], 20)
        model[name] = {'mean_vec': rng.randn(dim), 'model': [mr]}
    return model


@pytest.mark.parametrize('rank', [1, 3])
def test_eucos_and_openmax_match_jax(rank):
    names = ['a', 'b', 'c', 'd']
    dim = 24
    want_model = _weibull(jlibmr, np.random.RandomState(5), names, dim,
                          missing=('c',))
    got_model = _weibull(libmr, np.random.RandomState(5), names, dim,
                         missing=('c',))
    rng = np.random.RandomState(rank)
    feats = rng.randn(30, dim) * 2
    logits = rng.randn(30, 4) * 3
    mav = rng.randn(dim)
    np.testing.assert_allclose(tom.eucos_dist(mav, feats),
                               jom.eucos_dist(mav, feats), rtol=1e-6)
    want = jom.OpenMax(want_model, rank=rank)(logits, feats)
    got = tom.OpenMax(got_model, rank=rank)(logits, feats)
    assert got.shape == (30, 5)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got.sum(1), 1.0, rtol=1e-9)


def test_featureless_class_is_a_noop(tmp_path):
    """A class with no positive features: placeholder npz, no Weibull
    model, its logit passes through and moves no mass, as in JAX."""
    rng = np.random.RandomState(0)
    feats = {'a': [rng.randn(8) for _ in range(25)], 'b': [],
             'c': [rng.randn(8) + 1 for _ in range(30)]}
    refined = {'a': [rng.randn(8) for _ in range(22)], 'b': [], 'c': []}
    names = ['a', 'b', 'c']
    out = {}
    for tag, mod in (('port', tom), ('jax', jom)):
        d = str(tmp_path / tag)
        mod.save_mav_dist(d, mod.accumulate_mavs(feats),
                          mod.accumulate_mavs(refined), class_names=names)
        out[tag] = (d, mod.weibull_fitting(d, names, tailsize=20))
    for name in names:
        a = np.load(os.path.join(out['port'][0], f'{name}.npz'))
        b = np.load(os.path.join(out['jax'][0], f'{name}.npz'))
        assert set(a.files) == set(b.files)
        for k in a.files:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-6)
    wm, wpm = out['port'][1]
    assert wm['b']['model'] == [None] and wpm['b']['model'] == [None]
    # a class missing one stage takes the other stage's MAV
    np.testing.assert_array_equal(wpm['c']['mean_vec'],
                                  wm['c']['mean_vec'])
    x = rng.randn(10, 8)
    logits = rng.randn(10, 3)
    got = tom.OpenMax(wm)(logits, x)
    want = jom.OpenMax(out['jax'][1][0])(logits, x)
    np.testing.assert_allclose(got, want, rtol=1e-6)


# ---------------------------------------------------------- the model


@pytest.fixture(scope='module')
def openmax_data(tmp_path_factory):
    """(root, CLI config path) of a synthetic dataset with seeded
    closed-set port weights."""
    root = str(tmp_path_factory.mktemp('openmax') / 'synth')
    cfg_path = make_synthetic_dataset(root, n_train=2, n_test=3,
                                      clip_length=FRAME, crop_size=CROP,
                                      temporal_ramp=True)
    cfg = load_config(cfg_path, overrides=CLOSED_SET)
    model = factory.init_weights(factory.build_model(
        cfg, frame_num=FRAME, crop_size=CROP), seed=5)
    ckpt = os.path.join(root, 'softmax.ckpt')
    torch.save(model.state_dict(), ckpt)
    return root, cli_config(cfg_path, dict(CLOSED_SET, **{
        'testing.checkpoint_path': ckpt, 'model.compute_dtype': 'float32'}),
        os.path.join(root, 'openmax.yaml'))


def training_batches(cfg, n=4):
    infos = get_video_info(cfg.get_path('dataset.training.video_info_path'))
    annos = get_video_anno(infos,
                           cfg.get_path('dataset.training.video_anno_path'),
                           cfg.get_path('dataset.class_info_path'))
    ds = ThumosTrainDataset(cfg.get_path('dataset.training.video_data_path'),
                            infos, annos, clip_length=FRAME, crop_size=CROP,
                            stride=64, training=False, uint8_ingest=True)
    return [{k: v[None] for k, v in ds.sample(i).items()
             if k in ('clips', 'truths', 'labels', 'gt_mask')}
            for i in range(min(n, len(ds)))]


def test_extract_positive_features_matches_jax(openmax_data):
    root, cfg_path = openmax_data
    cfg = load_config(cfg_path)
    batches = training_batches(cfg)
    assert batches[0]['clips'].dtype == np.uint8
    _, idx_to_class = get_class_index_map(
        cfg.get_path('dataset.class_info_path'))
    jm = JBDNet(num_classes=5, frame_num=FRAME)
    variables = eval_shape_variables(jm, cfg.testing['checkpoint_path'],
                                     (1, FRAME, CROP, CROP, 3))
    want = jom.extract_positive_features(jm, variables, batches, FRAME,
                                         idx_to_class)
    tm = BDNet(num_classes=5, frame_num=FRAME, crop_size=CROP)
    tm.load_state_dict(from_jax_variables(variables))
    got = tom.extract_positive_features(tm, batches, FRAME, idx_to_class)
    n = 0
    for w_stage, g_stage in zip(want, got):
        assert set(w_stage) == set(g_stage)
        for name in w_stage:
            assert len(g_stage[name]) == len(w_stage[name])
            n += len(w_stage[name])
            if w_stage[name]:
                np.testing.assert_allclose(np.stack(g_stage[name]),
                                           np.stack(w_stage[name]),
                                           rtol=1e-3, atol=2e-3)
    assert n > 10


@pytest.fixture(scope='module')
def cli_runs(openmax_data):
    """JAX's three-stage CLI and the port's on the same config, each
    into its own output directory: {tag: (output dir, JSON path)}."""
    root, cfg_path = openmax_data
    out = {}
    for tag in ('jax', 'port'):
        cfg = cli_config(cfg_path, {
            'testing.output_path': os.path.join(root, f'out_{tag}')},
            os.path.join(root, f'openmax_{tag}.yaml'))
        if tag == 'jax':
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(jax_cli, 'load_variables', eval_shape_variables)
                jax_cli.main([cfg])
        else:
            port_cli.main([cfg, '--device', 'cpu'])
        out_dir = os.path.join(root, f'out_{tag}')
        out[tag] = (out_dir, os.path.join(out_dir,
                                          'detection_results.json'))
    return out


def test_cli_mav_files_match_jax(cli_runs):
    want_dir = os.path.join(cli_runs['jax'][0], 'mav_dist')
    got_dir = os.path.join(cli_runs['port'][0], 'mav_dist')
    assert sorted(os.listdir(got_dir)) == sorted(os.listdir(want_dir))
    for fn in os.listdir(want_dir):
        a, b = np.load(os.path.join(got_dir, fn)), \
            np.load(os.path.join(want_dir, fn))
        for k in b.files:
            assert a[k].shape == b[k].shape, (fn, k)
            np.testing.assert_allclose(a[k], b[k], rtol=1e-3, atol=2e-3,
                                       err_msg=f'{fn} {k}')


def test_cli_json_matches_jax(cli_runs):
    with open(cli_runs['jax'][1]) as f:
        want = json.load(f)
    with open(cli_runs['port'][1]) as f:
        got = json.load(f)
    assert_proposal_parity(want, got, min_total=50)


def test_cli_stages_are_idempotent(cli_runs, openmax_data, monkeypatch):
    """A second run reads the saved MAVs back (stage 1 is skipped)."""
    root, _ = openmax_data
    cfg = os.path.join(root, 'openmax_port.yaml')
    monkeypatch.setattr(port_cli, 'compute_mav_dist', lambda *a, **k: (
        _ for _ in ()).throw(AssertionError('stage 1 ran again')))
    port_cli.main([cfg, '--device', 'cpu', '--output_json', 'again.json'])
    with open(os.path.join(cli_runs['port'][0], 'again.json')) as f:
        again = json.load(f)
    with open(cli_runs['port'][1]) as f:
        first = json.load(f)
    assert again == first


def test_openmax_refuses_open_set_heads(openmax_data):
    _, cfg_path = openmax_data
    cfg = load_config(cfg_path, overrides={'model.os_head': True,
                                           'model.use_edl': True})
    with pytest.raises(ValueError, match='closed-set'):
        port_cli.closed_set_model(cfg, FRAME, CROP, torch.device('cpu'))
