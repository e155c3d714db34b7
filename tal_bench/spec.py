"""Where the benchmark finds what a cell is made of, by name.

`BENCHMARK.json` (at the root of the checkout) lists the cells, metrics
and configurations. Everything else is a file of its own under this
package, found by the name a cell or metric gives:

* `configs/<config>.json`: the configuration as it is run (`config`,
  the reference-schema YAML as JSON), its `source`, `assumed` and
  `reduced`;
* `workloads/<traffic>.json`: the traffic mix, the parameters one
  general generator reads, and the `runner` that drives it;
* `runners/<runner>.py`: a kind of cell (`Runner` class);
* `metrics/<metric>.py`: a per-layer metric's reader (`read(run)`).

A later change adds a cell, a configuration or a metric by adding
files, never by editing one.
"""

from __future__ import annotations

import importlib.util
import json
import os
from types import ModuleType
from typing import Any, Dict, List, Optional

PKG = os.path.dirname(os.path.abspath(__file__))


class SpecError(ValueError):
    """A cell, configuration, traffic mix or metric that is not there."""


def read_json(path: str) -> Any:
    with open(path, encoding='utf-8') as f:
        return json.load(f)


def benchmark(root: str = '.') -> Dict[str, Any]:
    path = os.path.join(root, 'BENCHMARK.json')
    if not os.path.isfile(path):
        raise SpecError(f'{path} not found: run from the checkout root')
    return read_json(path)


def _named(entries: List[Dict[str, Any]], name: str, what: str
           ) -> Dict[str, Any]:
    for e in entries:
        if e['name'] == name:
            return e
    raise SpecError(f'no {what} named {name!r} in BENCHMARK.json')


def _file(kind: str, name: str, ext: str, pkg: str = PKG) -> str:
    path = os.path.join(pkg, kind, name + ext)
    if not os.path.isfile(path):
        raise SpecError(f'{kind} {name!r}: {path} not found')
    return path


def load_module(path: str, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One cell: its entry in BENCHMARK.json, its configuration, its
    traffic mix, and the metrics it reports."""

    def __init__(self, bench: Dict[str, Any], workload: str,
                 pkg: str = PKG):
        self.pkg = pkg
        self.entry = _named(bench['workloads'], workload, 'workload')
        self.name = workload
        self.chips = int(self.entry['chips'])
        self.config_entry = _named(bench['configs'], self.entry['config'],
                                   'configuration')
        self.config_file = read_json(_file('configs', self.entry['config'],
                                           '.json', pkg))
        self.config: Dict[str, Any] = self.config_file['config']
        self.traffic: Dict[str, Any] = read_json(
            _file('workloads', self.entry['traffic'], '.json', pkg))
        self.end_to_end = [m for m in bench['end_to_end']
                           if self._reports(m)]
        self.per_layer = [m for m in bench['per_layer'] if self._reports(m)]

    def _reports(self, metric: Dict[str, Any]) -> bool:
        cells = metric.get('workloads')
        return cells is None or self.name in cells

    def runner_module(self) -> ModuleType:
        name = self.traffic['runner']
        return load_module(_file('runners', name, '.py', self.pkg),
                           f'tal_bench_runner_{name}')

    def reader(self, metric: str) -> ModuleType:
        return load_module(_file('metrics', metric, '.py', self.pkg),
                           'tal_bench_metric_' + metric.replace('.', '_'))


def seconds_of_trace(traffic: Dict[str, Any], seconds: float
                     ) -> Optional[float]:
    """The traced window of a `--trace 1` run: the traffic's
    `trace_seconds` where it is shorter than the run's."""
    cap = traffic.get('trace_seconds')
    return seconds if cap is None else min(float(cap), seconds)
