"""`post_behind_pct` in a whole traced run of test_mix at a tiny size on
the CPU, built as `test_tal_program_spans.py` builds its runs: the share
reads between 0 and 100, above 0 where the run made two flushes or more,
and a program without the recorder leaves it out."""

import pytest
import torch

from opental_torch.utils import profiling
from tal_bench import run
from tal_bench.tests import tiny

CPU = torch.device('cpu')
SEED = 2 ** 31 + 71
CELL = 'thumos14.infer.test_mix'


@pytest.fixture(scope='module')
def pkg(tmp_path_factory):
    torch.set_num_threads(2)
    return tiny.build(str(tmp_path_factory.mktemp('tiny') / 'pkg'))


def traced(pkg):
    bench, path = pkg
    args = run.parse(['--workload', CELL, '--seed', str(SEED),
                      '--seconds', '2', '--trace', '1'])
    return run.run(args, device=CPU, bench=bench, pkg=path)


def test_post_behind_is_a_share_of_the_windows(pkg):
    out = traced(pkg)
    assert out['correct'], out['checks']
    flushes = sum(s.name == 'ingest.plan' for s in profiling.recorded().spans)
    share = out['metrics']['post_behind_pct']['value']
    assert 0 <= share <= 100
    assert flushes >= 2
    assert share > 0


def test_a_program_without_the_recorder_leaves_it_out(pkg, monkeypatch):
    monkeypatch.delattr(profiling, 'recorded')
    out = traced(pkg)
    assert out['correct'], out['checks']
    assert 'device_idle_pct.infer' in out['metrics']
    assert 'post_behind_pct' not in out['metrics']
