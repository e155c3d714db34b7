"""The two-stream (`thumos14.infer.fused`) and ActivityNet
(`anet.infer.val`) inference cells in whole runs at a tiny size on the
CPU (the harness's look for a card skipped): a sound run is correct and
reports its metrics; each planted fault makes `correct` false (the flow
stream dropped from the fusion, the flow frames shifted by one frame, an
ANet proposal's class changed); the lower-precision controls read above
a limit; `flow_stream_pct` reads the program's counter and None without
it; a program without the ANet object fails the ANet cell at set-up."""

import pytest
import torch

from opental_torch.infer import pipeline
from opental_torch.tools import test_anet
from opental_torch.utils import profiling
from tal_bench import control, spec
from tal_bench.tests import tiny_streams
from tal_bench.tests.test_tal_faults import SEED, one_run

CPU = torch.device('cpu')
FUSED, ANET = 'thumos14.infer.fused', 'anet.infer.val'


@pytest.fixture(scope='module')
def pkg(tmp_path_factory):
    torch.set_num_threads(2)
    return tiny_streams.build(str(tmp_path_factory.mktemp('tiny') / 'pkg'))


@pytest.mark.parametrize('workload', [FUSED, ANET])
def test_sound_run_is_correct(pkg, workload):
    out = one_run(pkg, workload, trace=1)
    assert out['correct'], out['checks']
    m = out['metrics']
    for name in ('forward_fill_pct', 'infer_mfu', 'device_idle_pct.infer',
                 'idle_in_post_pct', 'idle_in_ingest_pct',
                 'nms_steps_per_window'):
        assert name in m, name
    # off the card the streams' time is not counted
    assert 'flow_stream_pct' not in m
    if workload == FUSED:
        assert set(out['checks']) >= {'rgb_rel', 'flow_rel'}


def test_dropped_flow_stream_fails(pkg, monkeypatch):
    monkeypatch.setattr(pipeline, 'fuse_streams', lambda out, flow: out)
    out = one_run(pkg, FUSED)
    checks = out['checks']
    assert not out['correct']
    assert checks['model_rel']['value'] > checks['model_rel']['limit']
    assert checks['flow_rel']['value'] <= checks['flow_rel']['limit']


def test_shifted_flow_frames_fail(pkg):
    def shift(runner):
        src = runner.source
        real = src.next

        def shifted():
            name, data, n, fps, start = real()
            src.flows[name] = src.flow_bank[start + 1:start + n]
            return name, data, n, fps, start
        src.next = shifted
    out = one_run(pkg, FUSED, prepare=shift)
    checks = out['checks']
    assert not out['correct']
    assert checks['flow_rel']['value'] > checks['flow_rel']['limit']
    assert checks['rgb_rel']['value'] <= checks['rgb_rel']['limit']


def test_changed_anet_class_fails(pkg):
    def alter(runner):
        run = runner.infer.run

        def altered(videos):
            results = run(videos)
            for props in results.values():
                if props:
                    props[0] = dict(props[0], cls=props[0]['cls'] % 150 + 1)
                    break
            return results
        runner.infer.run = altered
    out = one_run(pkg, ANET, prepare=alter)
    assert not out['correct']
    assert out['checks']['post_gap']['value'] > \
        out['checks']['post_gap']['limit']


@pytest.mark.parametrize('workload', [FUSED, ANET])
def test_the_control_fails(pkg, workload):
    bench, path = pkg
    cell = spec.Cell(bench, workload, path)
    runner = cell.runner_module().Runner(cell, SEED, CPU)
    runner.setup()
    runner.window(1.0)
    runner.release()
    limits = cell.traffic['check']['limits']
    low = control.infer_control(runner)
    assert any(low[k] > limits[k] for k in low), (low, limits)


def test_flow_stream_pct_reads_the_counter(pkg, monkeypatch):
    from types import SimpleNamespace
    bench, path = pkg
    reader = spec.Cell(bench, FUSED, path).reader('flow_stream_pct')
    run = SimpleNamespace(kind='infer', trace=SimpleNamespace(
        window_ns=(1000, 2_000_001_000), window_s=2.0))
    monkeypatch.setattr(profiling, 'recorded', lambda: profiling.Recorded(
        [], [profiling.Count(5000, 'stream.flow_ms', 500.0, 0),
             profiling.Count(9000, 'stream.rgb_ms', 700.0, 0)]))
    assert reader.read(run) == pytest.approx(25.0)
    monkeypatch.setattr(profiling, 'recorded',
                        lambda: profiling.Recorded([], []))
    assert reader.read(run) is None
    monkeypatch.delattr(profiling, 'recorded')
    assert reader.read(run) is None


def test_a_program_without_the_anet_object_fails_at_set_up(pkg,
                                                          monkeypatch):
    monkeypatch.delattr(test_anet, 'AnetInference')
    bench, path = pkg
    cell = spec.Cell(bench, ANET, path)
    runner = cell.runner_module().Runner(cell, SEED, CPU)
    with pytest.raises(ImportError):
        runner.setup()
