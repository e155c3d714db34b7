"""The benchmark of the PyTorch / CUDA port, one run of one cell:

    python -m tal_bench.run --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout. The cell, its configuration, traffic,
runner and metric readers are found by name (`tal_bench/spec.py`).
Set-up (imports, kernel builds, the model's seeded weights, the data,
warm-up) runs from process start to the window; the window runs the
program for `--seconds`; then the program's state is freed and its
outputs are compared with the plain reference (`correct`). With
`--trace 1` the window runs under the profiler (at most the traffic's
`trace_seconds`) and the per-layer metrics are read from it.

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics`, `device` (and `breakdown` with
`--trace 1`), then `checks`: each compared number with its limit, which
also close standard error. Without a card (or with fewer than the cell
asks for) the run fails and prints no result.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from typing import Any, Dict, List  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, '.tal_bench_cache')
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'opental_tpu')


def set_cache_dirs() -> None:
    """Every compiler cache at a fixed path inside the checkout (the
    port's own nvcc builds go to `opental_torch/_build/` already)."""
    for var, sub in (('TRITON_CACHE_DIR', 'triton'),
                     ('TORCHINDUCTOR_CACHE_DIR', 'inductor'),
                     ('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                     ('CUDA_CACHE_PATH', 'nv_compute')):
        os.environ[var] = os.path.join(CACHE, sub)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's (compared whole: `opental_torch` is not `opental_tpu`)."""
    return sorted({m.split('.')[0] for m in list(sys.modules)
                   if m.split('.')[0] in FORBIDDEN})


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


class RunInfo:
    """What a per-layer reader takes: the reduced trace, the runner's
    counters, the cell and its kind ('infer' or 'train')."""

    def __init__(self, cell, kind: str, reduced, counters: Dict[str, Any]):
        self.cell, self.kind = cell, kind
        self.trace = reduced
        self.counters = counters


def require_cards(chips: int) -> 'Any':
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('tal_bench: no CUDA device is available; the '
                         'benchmark measures the card and never the CPU')
    if torch.cuda.device_count() < chips:
        raise SystemExit(f'tal_bench: the cell asks for {chips} cards, '
                         f'{torch.cuda.device_count()} are available')
    return torch.device('cuda', 0)


def finite(x: float) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)


def run(args: argparse.Namespace, device=None, bench=None,
        pkg=None) -> Dict[str, Any]:
    """One run; returns the result object. `device` None means the card
    (required); the tests pass the CPU, and may pass another benchmark
    and package directory of cells."""
    from tal_bench import spec, trace
    set_cache_dirs()
    if bench is None:
        bench = spec.benchmark(ROOT)
    cell = spec.Cell(bench, args.workload, pkg or spec.PKG)
    if device is None:
        device = require_cards(cell.chips)
    import torch
    runner = cell.runner_module().Runner(cell, args.seed, device,
                                         trace=bool(args.trace))
    runner.setup()
    setup_s = time.perf_counter() - _T0
    prof = None
    seconds = args.seconds
    if args.trace:
        seconds = spec.seconds_of_trace(cell.traffic, seconds)
        prof = trace.Profiler()
        prof.start()
    try:
        with runner.spans.span('window'):
            e2e = runner.window(seconds)
    finally:
        if prof is not None:
            prof.stop()
    cuda = device.type == 'cuda'
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    counters = runner.counters() if args.trace else {}
    runner.release()
    attempted, failed = runner.attempts()
    checks = runner.check()
    metrics: Dict[str, Any] = {}
    dev: Dict[str, Any] = {
        'platform': 'gpu' if cuda else 'cpu',
        'kind': torch.cuda.get_device_name(device) if cuda else 'cpu',
        'count': cell.chips, 'memory_peak_bytes': int(peak)}
    result: Dict[str, Any] = {}
    if args.trace:
        reduced = trace.Reduced(prof.events, runner.spans)
        prof = None
        info = RunInfo(cell, runner.kind, reduced, counters)
        for m in cell.per_layer:
            value = cell.reader(m['name']).read(info)
            if value is not None:
                metrics[m['name']] = {'value': value, 'unit': m['unit']}
        dev['busy_s'] = reduced.busy_s
        dev['window_s'] = reduced.window_s
        traced = {'device_events': len(reduced.all_device),
                  'launches_in_window': reduced.launches}
        result['breakdown'] = {'device_ops': reduced.device_ops(),
                               'idle_gaps': reduced.idle_gaps()}
    else:
        e2e['setup_s'] = setup_s
        for m in cell.end_to_end:
            if m['name'] in e2e:
                metrics[m['name']] = {'value': e2e[m['name']],
                                      'unit': m['unit']}
    correct = all(finite(c['value']) and c['value'] <= c['limit']
                  for c in checks) and failed == 0
    out = {'correct': correct, 'attempted': attempted, 'failed': failed,
           'metrics': metrics, 'device': dev}
    out.update(result)
    out['window'] = runner.summary()
    if args.trace:
        out['window'].update(traced)
    out['checks'] = {c['name']: {'value': c['value'], 'limit': c['limit']}
                     for c in checks}
    return out


def main(argv=None) -> int:
    args = parse(argv)
    out = run(args)
    bad = forbidden_modules()
    if bad:
        print(f'tal_bench: the run loaded {", ".join(bad)}; the benchmark '
              'measures the PyTorch port alone', file=sys.stderr)
        return 3
    print('tal_bench: ' + json.dumps(out.pop('window', {})),
          file=sys.stderr)
    for name, c in out['checks'].items():
        print(f'check {name} {c["value"]!r} limit {c["limit"]!r}',
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
