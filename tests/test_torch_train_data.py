"""The port's training data path vs the JAX package's, on the CPU: on one
synthetic dataset, clip splitting, SSL cut-paste, crops and flips and the
dataset's batches are equal for the same seed, exactly; and the
background prefetch that feeds them to the step."""

import os
import random
import threading

import numpy as np
import pytest
import torch

from torch_suite import suite_policy  # noqa: F401 (autouse)

from opental_tpu.data import thumos as jth
from opental_tpu.data import transforms as jtf
from opental_tpu.utils.synthetic import make_synthetic_dataset as jmake

from opental_torch.config import load_config
from opental_torch.data import thumos as tth
from opental_torch.data import transforms as ttf
from opental_torch.data.prefetch import prefetch
from opental_torch.utils.synthetic import make_synthetic_dataset


@pytest.fixture(scope='module')
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('data') / 'synth')
    cfg_path = make_synthetic_dataset(root, n_train=4, n_test=1,
                                      clip_length=128, crop_size=32,
                                      spatial=40)
    cfg = load_config(cfg_path)
    infos = tth.get_video_info(cfg.dataset.training.video_info_path)
    annos = tth.get_video_anno(infos, cfg.dataset.training.video_anno_path,
                               cfg.dataset.class_info_path)
    return root, cfg, infos, annos


def test_synthetic_copy_matches(dataset, tmp_path):
    root, _, _, _ = dataset
    other = str(tmp_path / 'jax')
    jmake(other, n_train=4, n_test=1, clip_length=128, crop_size=32,
          spatial=40)
    for sub in ('val_npy', 'test_npy'):
        names = sorted(os.listdir(os.path.join(root, sub)))
        assert names == sorted(os.listdir(os.path.join(other, sub)))
        for n in names:
            np.testing.assert_array_equal(
                np.load(os.path.join(root, sub, n)),
                np.load(os.path.join(other, sub, n)))
    for f in ('val_video_info.csv', 'val_Annotation_known.csv',
              'Class_Index_Known.txt', 'gt_open.json'):
        with open(os.path.join(root, 'annotations', f)) as a, \
                open(os.path.join(other, 'annotations', f)) as b:
            assert a.read() == b.read(), f


def test_annotations_and_split(dataset):
    _, cfg, infos, annos = dataset
    assert infos == jth.get_video_info(cfg.dataset.training.video_info_path)
    assert annos == jth.get_video_anno(
        infos, cfg.dataset.training.video_anno_path,
        cfg.dataset.class_info_path)
    for stride in (30, 64):
        got, got_min = tth.split_videos(infos, annos, 128, stride)
        want, want_min = jth.split_videos(infos, annos, 128, stride)
        assert got_min == want_min
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert (g['video_name'], g['offset'], g['annos']) == \
                (w['video_name'], w['offset'], w['annos'])
            np.testing.assert_array_equal(g['scores'], w['scores'])


def test_boundary_heatmaps():
    annos = [[3.2, 40.7, 1], [0.0, 5.0, 2], [100.0, 127.9, 3]]
    np.testing.assert_array_equal(tth.boundary_heatmaps(annos, 128),
                                  jth.boundary_heatmaps(annos, 128))


@pytest.mark.parametrize('seed', range(6))
def test_transforms(seed):
    clip = np.random.RandomState(seed).randint(0, 256, (8, 40, 44, 3),
                                               dtype=np.uint8)
    ra, rb = random.Random(seed), random.Random(seed)
    for _ in range(3):
        got = ttf.random_hflip(ttf.random_crop(clip, 32, ra), ra)
        want = jtf.random_hflip(jtf.random_crop(clip, 32, rb), rb)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ttf.normalize_clip(clip),
                                  jtf.normalize_clip(clip))
    np.testing.assert_array_equal(ttf.center_crop(clip, 32),
                                  jtf.center_crop(clip, 32))


@pytest.mark.parametrize('seed', range(8))
def test_ssl_augment(seed):
    rng = np.random.RandomState(seed)
    clip = rng.randn(128, 4, 4, 3).astype(np.float32)
    annos = [[10.0, 60.0, 1], [80.0, 90.0, 2]] if seed % 2 else \
        [[5.0, 120.0, 1]]          # no background region: the fail path
    th = int(rng.randint(3, 12))
    ra, rb = random.Random(seed), random.Random(seed)
    got = tth.ssl_augment(clip, annos, th, ra)
    want = jth.ssl_augment(clip, annos, th, rb)
    assert got[2] == want[2]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert ra.getstate() == rb.getstate()


@pytest.mark.parametrize('uint8_ingest', [False, True])
def test_dataset_batches(dataset, uint8_ingest):
    _, cfg, infos, annos = dataset
    kw = dict(clip_length=128, crop_size=32, stride=64, seed=2020,
              uint8_ingest=uint8_ingest)
    npy = cfg.dataset.training.video_data_path
    got_ds = tth.ThumosTrainDataset(npy, infos, annos, **kw)
    want_ds = jth.ThumosTrainDataset(npy, infos, annos, **kw)
    n = 0
    for _ in range(2):                  # two epochs: the rng carries on
        for got, want in zip(got_ds.batches(2), want_ds.batches(2)):
            assert set(got) == set(want)
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            n += 1
    assert n >= 2
    assert got_ds.rng.getstate() == want_ds.rng.getstate()


def _prefetch_threads():
    return [t for t in threading.enumerate()
            if t.name == 'opental-torch-prefetch' and t.is_alive()]


def test_prefetch_order_and_stop():
    """CPU batches arrive in order as tensors on the device asked for;
    leaving the loop early stops the thread."""
    batches = [{'x': np.full((2, 3), i, np.float32)} for i in range(6)]
    got = [b['x'] for b in prefetch(iter(batches), torch.device('cpu'),
                                    depth=2)]
    assert [int(t[0, 0]) for t in got] == list(range(6))
    assert all(isinstance(t, torch.Tensor) for t in got)
    it = prefetch(iter(batches), torch.device('cpu'), depth=1)
    assert int(next(it)['x'][0, 0]) == 0
    it.close()
    assert not _prefetch_threads()


def test_prefetch_reraises_the_producers_error():
    def produce():
        yield {'x': np.zeros(2, np.float32)}
        raise ValueError('bad video')

    it = prefetch(produce(), torch.device('cpu'))
    next(it)
    with pytest.raises(ValueError, match='bad video'):
        next(it)
    assert not _prefetch_threads()
