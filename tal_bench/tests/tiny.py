"""A tiny copy of the benchmark's cells for the CPU tests: the same
runners, readers, configurations and traffic mixes, at 128-frame clips
(256 for ActivityNet), 32 x 32 crops and short videos."""

from __future__ import annotations

import json
import os
import shutil

from tal_bench import spec

ROOT = os.path.dirname(spec.PKG)


def build(dst: str):
    """Writes the tiny package under dst; returns (bench, pkg)."""
    for d in ('runners', 'metrics'):
        shutil.copytree(os.path.join(spec.PKG, d), os.path.join(dst, d))
    os.makedirs(os.path.join(dst, 'configs'))
    os.makedirs(os.path.join(dst, 'workloads'))
    bench = spec.benchmark(ROOT)
    for c in bench['configs']:
        f = spec.read_json(os.path.join(ROOT, c['file']))
        anet = f['config'].get('model', {}).get('arch') == 'anet'
        for ph in ('training', 'testing'):
            f['config']['dataset'][ph].update(
                clip_length=256 if anet else 128, crop_size=32)
        f['config']['dataset']['testing']['clip_stride'] = 64
        with open(os.path.join(dst, 'configs', c['name'] + '.json'),
                  'w') as out:
            json.dump(f, out)
    for name in os.listdir(os.path.join(spec.PKG, 'workloads')):
        t = spec.read_json(os.path.join(spec.PKG, 'workloads', name))
        if t['runner'] == 'infer_packed':
            t.update(spatial=40, bank_frames=3000, packed_batch=8,
                     packed_frames=1024, trace_seconds=2)
            if t['lengths']['dist'] == 'lognormal':
                t['lengths'].update(median=300, min=100, max=900,
                                    quantiles=6)
            else:
                t['lengths'].update(min=700, max=900, quantiles=3)
        else:
            t['tree']['thumos'].update(spatial=40, frames=[300, 400],
                                       gt_frames=[10, 50])
            t['tree']['anet'].update(spatial=40, frames=[200, 256],
                                     videos=6, gt_frames=[10, 60])
        with open(os.path.join(dst, 'workloads', name), 'w') as out:
            json.dump(t, out)
    return bench, dst
