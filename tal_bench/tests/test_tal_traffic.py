"""Seeded traffic: a seed reproduces its data, the lengths follow each
mix, and the training trees are in the reference's schema."""

import csv
import hashlib
import json
import os
import statistics

import numpy as np
import pytest
import torch

from tal_bench import spec, traffic

CPU = torch.device('cpu')


def mix(name):
    return spec.read_json(os.path.join(spec.PKG, 'workloads', name))


def test_frames_repeat_for_a_seed_and_differ_across_seeds():
    a = traffic.frames(2 ** 31 + 7, 'bank', 40, 16, CPU)
    b = traffic.frames(2 ** 31 + 7, 'bank', 40, 16, CPU)
    c = traffic.frames(2 ** 31 + 8, 'bank', 40, 16, CPU)
    assert a.dtype == np.uint8 and a.shape == (40, 16, 16, 3)
    assert np.array_equal(a, b) and not np.array_equal(a, c)


def test_frames_carry_the_ramp():
    f = traffic.frames(3, 'bank', traffic.RAMP_PERIOD, 8, CPU)
    means = f.reshape(len(f), -1).mean(1)
    mid = traffic.RAMP_PERIOD // 2
    # the ramp climbs from -A at frame 0 to +A at half a period
    assert means[mid - 64:mid].mean() - means[:64].mean() > \
        1.5 * traffic.RAMP_AMPLITUDE


def test_test_mix_lengths_are_log_normal_quantiles():
    spec_ = mix('infer.test_mix.json')['lengths']
    base = traffic.length_set(spec_)
    assert len(base) == spec_['quantiles']
    assert statistics.median(base) == pytest.approx(spec_['median'],
                                                    rel=0.05)
    logs = np.log(base)
    assert np.std(logs) == pytest.approx(spec_['sigma'], rel=0.15)
    assert min(base) >= spec_['min'] and max(base) <= spec_['max']


def test_long_lengths_are_uniform_quantiles():
    spec_ = mix('infer.long.json')['lengths']
    base = traffic.length_set(spec_)
    assert min(base) >= spec_['min'] and max(base) <= spec_['max']
    assert np.mean(base) == pytest.approx((spec_['min'] + spec_['max'])
                                          / 2, rel=0.01)


def test_every_seed_draws_the_same_set_in_another_order():
    spec_ = mix('infer.test_mix.json')['lengths']
    q = spec_['quantiles']
    runs = []
    for seed in (1, 2 ** 31 + 5):
        it = traffic.lengths(spec_, seed)
        runs.append([next(it) for _ in range(2 * q)])
    for r in runs:
        assert sorted(r[:q]) == sorted(r[q:]) == \
            sorted(traffic.length_set(spec_))
    assert runs[0] != runs[1]
    again = traffic.lengths(spec_, 1)
    assert [next(again) for _ in range(2 * q)] == runs[0]


def test_video_source_views_the_bank():
    t = dict(mix('infer.test_mix.json'), bank_frames=2000, spatial=8)
    t['lengths'] = dict(t['lengths'], max=1500, median=400)
    src = traffic.VideoSource(t, 11, CPU)
    name, data, n, fps, start = src.next()
    assert data.base is not None and len(data) == n and fps == 10.0
    assert np.array_equal(data, src.bank[start:start + n])


def _digest(root):
    h = hashlib.sha256()
    for dirpath, _, files in sorted(os.walk(root)):
        for f in sorted(files):
            with open(os.path.join(dirpath, f), 'rb') as fh:
                h.update(f.encode() + fh.read())
    return h.hexdigest()


@pytest.mark.parametrize('arch', ['thumos', 'anet'])
def test_trees_repeat_for_a_seed(tmp_path, arch):
    tree = dict(mix('train.published.json')['tree'][arch], spatial=8,
                frames=[300, 320])
    make = traffic.anet_tree if arch == 'anet' else traffic.thumos_tree
    paths = [make(str(tmp_path / d), 2 ** 31 + 3, tree, 15, 8, CPU)
             for d in ('a', 'b')]
    make(str(tmp_path / 'c'), 2 ** 31 + 4, tree, 15, 8, CPU)
    a, b, c = (_digest(str(tmp_path / d)) for d in 'abc')
    assert a.replace('/a/', '') == b.replace('/b/', '') and a != c
    info = paths[0]['dataset.training.video_info_path']
    if arch == 'thumos':
        rows = list(csv.DictReader(open(info)))
        assert len(rows) == tree['videos']
        annos = list(csv.reader(open(
            paths[0]['dataset.training.video_anno_path'])))[1:]
        assert all(1 <= int(r[2]) <= 15 for r in annos)
    else:
        infos = json.load(open(info))
        assert len(infos) == tree['videos']
        assert all(1 <= a['label_id'] <= 15 for v in infos.values()
                   for a in v['annotations'])
