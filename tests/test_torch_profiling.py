"""`opental_torch.utils.profiling` on the CPU: `trace` writes a non-empty
Chrome trace of what ran in its block, with the program's spans on rows
of their own at the profiler's times and its counters as counter
tracks; `PhaseTimer` writes the JSON keys of the JAX package's timer
(`opental_tpu/utils/profiling.py`) with the same means;
`device_memory_stats` has the JAX key names (and, without a card, no
entry). The recorder itself: `tests/test_torch_tracing.py`."""

import json

import pytest
import torch

from torch_suite import suite_policy  # noqa: F401 (autouse)

from opental_tpu.utils import profiling as jprof

from opental_torch.utils import profiling


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path / 'tb')) as prof:
        y = (x @ x).relu().sum()
    assert float(y) > 0
    path = tmp_path / 'tb' / profiling.TRACE_FILE
    assert path.stat().st_size > 0
    with open(path) as f:
        events = json.load(f)['traceEvents']
    assert any('matmul' in e.get('name', '') or 'mm' in e.get('name', '')
               for e in events)
    assert prof.key_averages()


def test_phase_timer_matches_the_jax_timer(tmp_path, monkeypatch):
    """The same phases on a fake clock: equal report and dump."""
    timers = [profiling.PhaseTimer(), jprof.PhaseTimer()]
    for mod, timer in zip((profiling, jprof), timers):
        ticks = iter([0.0, 1.0, 10.0, 13.0, 20.0, 20.5])
        monkeypatch.setattr(mod.time, 'perf_counter', lambda: next(ticks))
        for name in ('a', 'b', 'a'):
            with timer.phase(name, sync=torch.zeros(2) if mod is profiling
                             else None):
                pass
        monkeypatch.undo()
    assert timers[0].report() == timers[1].report() == {'a': 0.75,
                                                        'b': 3.0}
    dumps = []
    for i, timer in enumerate(timers):
        path = tmp_path / f'sub{i}' / 'phases.json'
        timer.dump(str(path))
        with open(path) as f:
            dumps.append(json.load(f))
    assert dumps[0] == dumps[1]
    assert set(dumps[0]) == {'mean_seconds', 'total_seconds', 'counts'}


def test_phase_timer_counts_a_failing_phase():
    timer = profiling.PhaseTimer()
    with pytest.raises(ValueError):
        with timer.phase('x', sync=[torch.ones(1), {'k': torch.ones(1)}]):
            raise ValueError
    assert timer.counts == {'x': 1}


def test_device_memory_stats():
    stats = profiling.device_memory_stats()
    if not torch.cuda.is_available():
        assert stats == {}
        return
    for s in stats.values():
        assert set(s) == {'bytes_in_use', 'peak_bytes_in_use'}


def test_trace_writes_the_spans_into_its_chrome_file(tmp_path):
    x = torch.randn(256, 256)
    with profiling.trace(str(tmp_path)):
        with profiling.span('matmul', 'r1', n=1):
            x @ x
    with open(tmp_path / profiling.TRACE_FILE) as f:
        events = json.load(f)['traceEvents']
    mine = [e for e in events if e.get('cat') == 'opental_torch']
    assert [e['name'] for e in mine] == ['matmul']
    assert mine[0]['args'] == {'n': 1, 'rid': 'r1'}
    mm = [e for e in events if e.get('name') == 'aten::mm']
    assert mm and all(mine[0]['ts'] <= e['ts'] <= mine[0]['ts']
                      + mine[0]['dur'] for e in mm)
    assert mine[0]['tid'] != mm[0]['tid']
    rows = [e for e in events if e.get('ph') == 'M'
            and e.get('tid') == mine[0]['tid']]
    assert rows and rows[0]['args']['name'].startswith('opental_torch spans')


def test_trace_writes_the_counters_into_its_chrome_file(tmp_path):
    with profiling.trace(str(tmp_path)):
        profiling.count('rows', 3)
        torch.ones(4).sum()
        profiling.count('rows', 2)
    with open(tmp_path / profiling.TRACE_FILE) as f:
        events = json.load(f)['traceEvents']
    track = [e for e in events if e.get('ph') == 'C'
             and e.get('cat') == 'opental_torch']
    assert [(e['name'], e['args']) for e in track] == [
        ('rows', {'rows': 3}), ('rows', {'rows': 5})]
    assert track[0]['ts'] <= track[1]['ts']
