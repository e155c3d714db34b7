"""The readers of the program's spans and counters in whole traced runs
at a tiny size on the CPU (no card: every instant of the window is idle
on the device): each cell reports its new metrics, the layers' shares of
disjoint main-thread spans add up to at most the device's idle share,
and with a program that has no recorder the run still succeeds and
leaves those metrics out."""

import pytest
import torch

from opental_torch.utils import profiling
from tal_bench import run
from tal_bench.tests import tiny

CPU = torch.device('cpu')
SEED = 2 ** 31 + 33
CELLS = {
    'thumos14.infer.test_mix': (('idle_in_post_pct', 'idle_in_ingest_pct'),
                                'device_idle_pct.infer',
                                'nms_steps_per_window'),
    'thumos14.train.bs1': (('idle_in_loader_pct.train',
                            'idle_in_loss_pct.train'),
                           'device_idle_pct.train', None),
}


@pytest.fixture(scope='module')
def pkg(tmp_path_factory):
    torch.set_num_threads(2)
    return tiny.build(str(tmp_path_factory.mktemp('tiny') / 'pkg'))


def traced(pkg, workload):
    bench, path = pkg
    args = run.parse(['--workload', workload, '--seed', str(SEED),
                      '--seconds', '2', '--trace', '1'])
    return run.run(args, device=CPU, bench=bench, pkg=path)


@pytest.mark.parametrize('workload', sorted(CELLS))
def test_new_metrics_are_reported(pkg, workload):
    shares, idle, counter = CELLS[workload]
    out = traced(pkg, workload)
    assert out['correct'], out['checks']
    m = {k: v['value'] for k, v in out['metrics'].items()}
    assert all(0 <= m[s] <= 100 for s in shares)
    assert sum(m[s] for s in shares) <= m[idle] + 1e-9
    if counter:
        assert m[counter] > 0


@pytest.mark.parametrize('workload', sorted(CELLS))
def test_a_program_without_the_recorder_reads_nothing(pkg, workload,
                                                      monkeypatch):
    monkeypatch.delattr(profiling, 'recorded')
    shares, idle, counter = CELLS[workload]
    out = traced(pkg, workload)
    assert out['correct'], out['checks']
    assert idle in out['metrics']
    assert not set(shares + (counter,)) & set(out['metrics'])
