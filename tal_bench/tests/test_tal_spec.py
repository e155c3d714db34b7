"""The harness is driven by data: cells, configurations, traffic mixes,
runners and metric readers are found by name, and a run refuses to
measure without a card."""

import os
import shutil
import subprocess
import sys

import pytest

from tal_bench import spec

ROOT = os.path.dirname(spec.PKG)


def test_every_cell_resolves():
    bench = spec.benchmark(ROOT)
    for w in bench['workloads']:
        cell = spec.Cell(bench, w['name'])
        assert cell.runner_module().Runner
        assert any(m['name'] == 'setup_s' for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert callable(cell.reader(m['name']).read)


def test_each_per_layer_metric_moves_a_metric_its_cells_report():
    bench = spec.benchmark(ROOT)
    e2e = {m['name']: m for m in bench['end_to_end']}
    for m in bench['per_layer']:
        target = e2e[m['moves']]
        for w in m['workloads']:
            assert target.get('workloads') is None or \
                w in target['workloads'], (m['name'], w)


def test_a_copied_workload_file_is_found_under_its_new_name(tmp_path):
    pkg = tmp_path / 'pkg'
    shutil.copytree(spec.PKG, pkg, ignore=shutil.ignore_patterns(
        '__pycache__', 'tests', 'reference'))
    shutil.copy(pkg / 'workloads' / 'infer.test_mix.json',
                pkg / 'workloads' / 'infer.copied_mix.json')
    bench = spec.benchmark(ROOT)
    bench['workloads'].append({
        'name': 'thumos14.infer.copied_mix',
        'config': 'thumos14_opental_final', 'traffic': 'infer.copied_mix',
        'chips': 1, 'why': 'a copy'})
    for m in bench['end_to_end'] + bench['per_layer']:
        if 'thumos14.infer.test_mix' in m.get('workloads', []):
            m['workloads'].append('thumos14.infer.copied_mix')
    cell = spec.Cell(bench, 'thumos14.infer.copied_mix', str(pkg))
    orig = spec.Cell(spec.benchmark(ROOT), 'thumos14.infer.test_mix')
    assert cell.traffic == orig.traffic
    assert cell.runner_module().__file__.startswith(str(pkg))
    assert [m['name'] for m in cell.per_layer] == \
        [m['name'] for m in orig.per_layer]
    with pytest.raises(spec.SpecError):
        spec.Cell(bench, 'no.such.cell', str(pkg))


def test_a_run_without_a_card_fails_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, '-m', 'tal_bench.run', '--workload',
         'thumos14.infer.test_mix', '--seed', str(2 ** 31 + 9),
         '--seconds', '1', '--trace', '0'],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=''))
    assert out.returncode != 0
    assert 'no CUDA device' in out.stderr
    assert not any(line.startswith('{') for line in out.stdout.splitlines())


def test_a_run_outside_a_checkout_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, 'BENCHMARK.json'), tmp_path)
    shutil.copytree(spec.PKG, tmp_path / 'tal_bench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    out = subprocess.run(
        [sys.executable, '-m', 'tal_bench.run', '--workload',
         'thumos14.train.bs1', '--seed', '5', '--seconds', '1'],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != 'PYTHONPATH'})
    assert out.returncode != 0
    assert not any(line.startswith('{') for line in out.stdout.splitlines())

