"""`tiny.build` with the two-stream and ActivityNet inference cells'
traffic cut to the tiny size too (`tiny.build` shrinks only
`infer_packed`'s traffic and the training trees)."""

from __future__ import annotations

import json
import os

from tal_bench import spec
from tal_bench.tests import tiny

SHRINK = {
    'infer_fused': lambda t: (
        t.update(spatial=40, bank_frames=3000, packed_batch=8,
                 packed_frames=1024, trace_seconds=2),
        t['lengths'].update(median=300, min=100, max=900, quantiles=6)),
    'infer_anet': lambda t: (
        t.update(spatial=40, bank_frames=3000, video_batch=2,
                 trace_seconds=2),
        t['frames'].update(min=200, max=256, quantiles=3)),
}


def build(dst: str):
    """Writes the tiny package under dst; returns (bench, pkg)."""
    bench, pkg = tiny.build(dst)
    folder = os.path.join(pkg, 'workloads')
    for name in os.listdir(folder):
        path = os.path.join(folder, name)
        t = spec.read_json(path)
        if t['runner'] in SHRINK:
            SHRINK[t['runner']](t)
            with open(path, 'w') as out:
                json.dump(t, out)
    return bench, pkg
