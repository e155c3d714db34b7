"""Profiling and tracing hooks (counterpart of
`opental_tpu/utils/profiling.py`).

`trace(logdir)` records a `torch.profiler` trace (host and, where there
is a card, device activity) around a block and writes it as a Chrome
trace file into `logdir`. `PhaseTimer` accumulates wall time per named
phase, waiting for the card where asked, and writes the JSON the JAX
package's timer writes. `device_memory_stats` reads the allocator's
counters under the JAX key names.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, Iterator, Optional

import torch
from torch.profiler import ProfilerActivity, profile

TRACE_FILE = 'trace.json'


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[profile]:
    """Record what runs in the block, host and card (`with
    profiling.trace('/tmp/tb') as prof: run_step()`); on exit the trace
    is written to `logdir/trace.json` (chrome://tracing, Perfetto). The
    profiler is yielded for `key_averages()`."""
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def _wait_for(sync: Any) -> None:
    """Wait until the work that produced `sync` is done: a CUDA tensor's
    stream (the current stream of its device), or every tensor of a
    list, tuple or dict."""
    if isinstance(sync, torch.Tensor):
        if sync.is_cuda:
            torch.cuda.current_stream(sync.device).synchronize()
    elif isinstance(sync, dict):
        for v in sync.values():
            _wait_for(v)
    elif isinstance(sync, (list, tuple)):
        for v in sync:
            _wait_for(v)


class PhaseTimer:
    """Accumulating wall-clock phase timer; with `sync` a phase ends when
    the card has finished the work queued for the given tensor(s)."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync: Optional[Any] = None
              ) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                _wait_for(sync)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> Dict[str, float]:
        return {name: self.totals[name] / max(self.counts[name], 1)
                for name in self.totals}

    def dump(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, 'w') as f:
            json.dump({'mean_seconds': self.report(),
                       'total_seconds': self.totals,
                       'counts': self.counts}, f, indent=2)


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """Per card {'bytes_in_use', 'peak_bytes_in_use'} (bytes) from the
    caching allocator; empty without a card."""
    stats = {}
    if not torch.cuda.is_available():
        return stats
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        stats[f'cuda:{i}'] = {
            'bytes_in_use': s.get('allocated_bytes.all.current', 0),
            'peak_bytes_in_use': s.get('allocated_bytes.all.peak', 0),
        }
    return stats
