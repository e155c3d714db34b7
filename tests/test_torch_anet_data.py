"""The port's ActivityNet data path vs the JAX package's, on the CPU.

The port's `make_synthetic_anet_dataset` (frame 256, crop 32, videos of
128 to 256 frames at 40 x 40, so most are padded) writes the same files
as the JAX package's. `AnetTrainDataset` then gives the same samples in
both packages from one seed, exactly: the float32 path (127.5 pad,
normalized on the host) and the uint8 path (raw clips with the
`pad_masks` / `ssl_pad_masks` companions that the SSL cut-paste moves),
with and without `binary_class`. The port's `device_ingest` turns a
uint8 batch into the float32 batch exactly, and equals the JAX
package's.
"""

import filecmp
import json
import os

import numpy as np
import pytest
import torch

from torch_suite import suite_policy  # noqa: F401 (autouse)

import jax.numpy as jnp

from opental_tpu.data import anet as jax_anet
from opental_tpu.train.step import device_ingest as jax_device_ingest
from opental_tpu.utils.synthetic import \
    make_synthetic_anet_dataset as jax_make_dataset

from opental_torch.data import anet
from opental_torch.train.step import device_ingest
from opental_torch.utils.synthetic import make_synthetic_anet_dataset

CLIP, CROP = 256, 32


@pytest.fixture(scope='module')
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('anet_data'))
    port_cfg = make_synthetic_anet_dataset(os.path.join(root, 'port'),
                                           n_train=6, n_val=2,
                                           clip_length=CLIP, crop_size=CROP)
    jax_make_dataset(os.path.join(root, 'jax'), n_train=6, n_val=2,
                     clip_length=CLIP, crop_size=CROP)
    return root, port_cfg


def test_synthetic_dataset_matches_jax(dataset):
    root, _ = dataset
    port, ref = os.path.join(root, 'port'), os.path.join(root, 'jax')
    names = sorted(os.listdir(os.path.join(ref, 'npy')))
    assert names and names == sorted(os.listdir(os.path.join(port, 'npy')))
    for name in names:
        np.testing.assert_array_equal(
            np.load(os.path.join(port, 'npy', name)),
            np.load(os.path.join(ref, 'npy', name)))
    for rel in ('annotations/video_info.json', 'annotations/gt_open.json',
                'annotations/action_known.txt'):
        assert filecmp.cmp(os.path.join(port, rel), os.path.join(ref, rel),
                           shallow=False), rel


def info_paths(dataset):
    root, _ = dataset
    base = os.path.join(root, 'port')
    return (os.path.join(base, 'annotations', 'video_info.json'),
            os.path.join(base, 'npy'))


def test_split_videos_match_jax(dataset):
    info_path, npy = info_paths(dataset)
    for subset in ('training', 'validation'):
        info = anet.get_video_info(info_path, subset)
        assert info == jax_anet.get_video_info(info_path, subset)
        for binary in (False, True):
            got, got_th = anet.split_videos(info, CLIP, npy, binary)
            want, want_th = jax_anet.split_videos(info, CLIP, npy, binary)
            assert got_th == want_th
            assert len(got) == len(want) > 0
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.pop('scores'),
                                              w.pop('scores'))
                assert g == w


def batches(module, dataset, uint8, binary=False, training=True):
    info_path, npy = info_paths(dataset)
    ds = module.AnetTrainDataset(info_path, npy, clip_length=CLIP,
                                 crop_size=CROP, seed=5,
                                 uint8_ingest=uint8, binary_class=binary,
                                 training=training)
    return [b for _ in range(2) for b in ds.batches(2)]


@pytest.mark.parametrize('uint8,binary,training', [
    (False, False, True), (True, False, True), (True, True, True),
    (False, False, False)])
def test_samples_match_jax(dataset, uint8, binary, training):
    got = batches(anet, dataset, uint8, binary, training)
    want = batches(jax_anet, dataset, uint8, binary, training)
    assert len(got) == len(want) == (6 if training else 2)
    flags = 0.0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        flags += float(w['ssl_flags'].sum())
        if uint8:
            assert g['clips'].dtype == np.uint8
    assert flags > 0, 'no SSL cut-paste succeeded'
    if uint8:
        assert any(b['pad_masks'].any() for b in got), 'no padded clip'


def test_device_ingest_applies_pad_masks(dataset):
    """uint8 batch + pad masks -> the float32 path's clips exactly (the
    127.5 pad normalizes to 0.0), as the JAX package's device_ingest."""
    u8 = batches(anet, dataset, True)
    f32 = batches(anet, dataset, False)
    for bu, bf in zip(u8, f32):
        got = device_ingest({k: torch.from_numpy(v) for k, v in bu.items()})
        assert 'pad_masks' not in got and 'ssl_pad_masks' not in got
        want = jax_device_ingest({k: jnp.asarray(v) for k, v in bu.items()})
        for k in ('clips', 'ssl_clips'):
            g = got[k].permute(0, 2, 3, 4, 1).numpy()
            np.testing.assert_array_equal(g, bf[k], err_msg=k)
            np.testing.assert_array_equal(g, np.asarray(want[k]), err_msg=k)


def test_info_json_schema(dataset):
    info_path, _ = info_paths(dataset)
    with open(info_path) as f:
        info = json.load(f)
    v = next(iter(info.values()))
    assert set(v) >= {'subset', 'frame_num', 'fps', 'duration',
                      'annotations'}
