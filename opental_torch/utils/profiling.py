"""Profiling and tracing hooks (counterpart of
`opental_tpu/utils/profiling.py`), and the program's own spans and
counters.

`trace(logdir)` records a `torch.profiler` trace (host and, where there
is a card, device activity) around a block and writes it as a Chrome
trace file into `logdir`, with the program's spans and counters beside
the profiler's events. `PhaseTimer` accumulates wall time per named phase,
waiting for the card where asked, and writes the JSON the JAX package's
timer writes. `device_memory_stats` reads the allocator's counters under
the JAX key names.

The recorder. `span(name, rid, **attrs)` marks a layer's work (ingest,
forwards, post-processing and soft-NMS, the train step's phases, the
loaders; README lists the names) and `count(name, n)` adds to a
counter (n a number, or a function read with the recording);
`device_ms(name, device)` counts a block's time on the card between
two CUDA events, made only while recording. They
record only while a `torch.profiler` session is recording in the
process or an operator has entered `recording()`. The profiler's
state belongs to the thread that started it, so each span entry on the
main thread polls it (under a microsecond) and sets a module flag for
every thread (the prefetch and loader threads follow the main thread);
while off, a count, and a span on any other thread, reads that flag and
returns, and a call without attributes allocates nothing. A span keeps
its name, start and end on `time.time_ns()` (the clock of the device
trace's timestamps), its thread, the index of its parent (the innermost
span open on its thread) and a request id: the video's name, the flush,
the step or the clip. Each time recording starts, the store starts
empty; `recorded()` gives what it holds. Spans are never sent to the
profiler: they add no event to its trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import threading
import time
from typing import (Any, Callable, Dict, Iterator, List, NamedTuple,
                    Optional, Union)

TRACE_FILE = 'trace.json'


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: Optional[int]       # None while the span is open
    thread: int                 # threading.get_ident() of its thread
    parent: int                 # index of its parent span, -1 for none
    rid: Any                    # request id (video name, flush, step, clip)
    attrs: Optional[Dict[str, Any]]


class Count(NamedTuple):
    t_ns: int
    name: str
    n: float
    thread: int


class Recorded(NamedTuple):
    spans: List[Span]
    counts: List[Count]


class _Store:
    """One recording: spans as plain tuples in `Span`'s field order
    (reserved at entry, so a parent's index is known to its children),
    and counts as plain tuples in `Count`'s."""

    def __init__(self):
        self.spans: List[tuple] = []
        self.counts: List[tuple] = []


_ON = False                # whether `span` and `count` record now
_FORCED = 0                # `recording()` blocks open
_MAIN = threading.main_thread().ident
_LOCK = threading.Lock()
_TLS = threading.local()   # each thread's stack of open spans
_STORE = _Store()
OFF = contextlib.nullcontext()     # what `span` returns while off


def _profiler_enabled() -> bool:
    """Whether a torch profiler records on this thread (never before
    torch is imported: the datasets' module imports no torch)."""
    torch = sys.modules.get('torch')
    return torch is not None and torch._C._autograd._profiler_enabled()


def _set(on: bool) -> None:
    """Turn recording on or off; a new recording starts an empty
    store."""
    global _ON, _STORE
    if on != _ON:
        with _LOCK:
            if on and not _ON:
                _STORE = _Store()
            _ON = on


def refresh() -> None:
    """On the main thread, record from now on exactly while a
    `recording()` block is open or the profiler records (elsewhere a
    no-op: the profiler's state is the main thread's). Each span entry
    calls it; so does `prefetch_items` before it starts its thread."""
    if threading.get_ident() == _MAIN:
        _set(_FORCED > 0 or _profiler_enabled())


def _stack() -> List['_Open']:
    try:
        return _TLS.stack
    except AttributeError:
        _TLS.stack = []
        return _TLS.stack


class _Open:
    __slots__ = ('name', 'rid', 'attrs', 'store', 'index')

    def __init__(self, name: str, rid: Any, attrs: Optional[Dict]):
        self.name, self.rid, self.attrs = name, rid, attrs

    def __enter__(self) -> '_Open':
        stack = _stack()
        store = self.store = _STORE
        top = stack[-1] if stack else None
        parent = top.index if top is not None and top.store is store \
            else -1
        with _LOCK:
            self.index = len(store.spans)
            store.spans.append((self.name, time.time_ns(), None,
                                threading.get_ident(), parent, self.rid,
                                self.attrs))
        stack.append(self)
        return self

    def __exit__(self, *exc) -> bool:
        end = time.time_ns()
        _stack().pop()
        spans = self.store.spans
        rec = spans[self.index]
        spans[self.index] = rec[:2] + (end,) + rec[3:]
        return False


def span(name: str, rid: Any = None, **attrs: Any):
    """A context manager that records the block as span `name` with the
    request id `rid` and `attrs`, while recording is on (a no-op
    otherwise)."""
    refresh()
    if not _ON:
        return OFF
    return _Open(name, rid, attrs or None)


def count(name: str, n: Union[float, Callable[[], float]] = 1) -> None:
    """Add n to counter `name`, while recording is on. n may be a
    function of no arguments, called when the recording is read
    (`recorded()`): a count of a value on the card then waits for the
    card there, and not where it is made."""
    if not _ON:
        return
    t = time.time_ns()
    with _LOCK:
        _STORE.counts.append((t, name, n, threading.get_ident()))


@contextlib.contextmanager
def device_ms(name: str, device: Any) -> Iterator[None]:
    """Count the card's milliseconds between two CUDA events recorded on
    the current stream before and after the block as counter `name`,
    read with the recording (no sync here). Off the card, or while not
    recording, no event is made and nothing is counted."""
    if not _ON or getattr(device, 'type', None) != 'cuda':
        yield
        return
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    yield
    end.record()

    def elapsed() -> float:
        end.synchronize()
        return start.elapsed_time(end)
    count(name, elapsed)


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Record spans and counts in the block, with or without a
    profiler (`with profiling.recording(): run(); rec =
    profiling.recorded()`)."""
    global _FORCED
    with _LOCK:
        _FORCED += 1
    _set(True)
    try:
        yield
    finally:
        with _LOCK:
            _FORCED -= 1
        _set(_FORCED > 0 or _profiler_enabled())


def recorded() -> Recorded:
    """The spans (open ones with end_ns None) and counts of the current
    recording, or of the last one once it has ended; a count made with a
    function is read here, once."""
    store = _STORE
    with _LOCK:
        spans, counts = list(store.spans), list(store.counts)
    for k, c in enumerate(counts):
        if callable(c[2]):
            counts[k] = c[:2] + (c[2](),) + c[3:]
            with _LOCK:
                store.counts[k] = counts[k]
    return Recorded([Span(*s) for s in spans], [Count(*c) for c in counts])


def _chrome_events(rec: Recorded, base_ns: int = 0
                  ) -> List[Dict[str, Any]]:
    """Complete events ('X', microseconds from base_ns) of the closed
    spans, on one row per thread of their own, named after it, and a
    counter track ('C') per counter with its running total."""
    pid = os.getpid()
    names = {t.ident: t.name for t in threading.enumerate()}
    events, rows = [], set()
    for s in rec.spans:
        if s.end_ns is None:
            continue
        args = dict(s.attrs or {})
        if s.rid is not None:
            args['rid'] = s.rid
        events.append({'ph': 'X', 'cat': 'opental_torch', 'name': s.name,
                       'pid': pid, 'tid': s.thread,
                       'ts': (s.start_ns - base_ns) / 1e3,
                       'dur': (s.end_ns - s.start_ns) / 1e3,
                       'args': args})
        rows.add(s.thread)
    for tid in sorted(rows):
        events.append({'ph': 'M', 'name': 'thread_name', 'pid': pid,
                       'tid': tid, 'args': {
                           'name': 'opental_torch spans: '
                           + names.get(tid, f'thread {tid}')}})
    totals: Dict[str, float] = {}
    for c in sorted(rec.counts):
        totals[c.name] = totals.get(c.name, 0) + c.n
        events.append({'ph': 'C', 'cat': 'opental_torch', 'name': c.name,
                       'pid': pid, 'ts': (c.t_ns - base_ns) / 1e3,
                       'args': {c.name: totals[c.name]}})
    return events


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[Any]:
    """Record what runs in the block, host and card (`with
    profiling.trace('/tmp/tb') as prof: run_step()`); on exit the trace
    is written to `logdir/trace.json` (chrome://tracing, Perfetto), with
    the program's spans of the block on rows of their own and its
    counters as counter tracks of running totals. The profiler
    is yielded for `key_averages()`."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with recording():
            t0 = time.time_ns()
            yield prof
    path = os.path.join(logdir, TRACE_FILE)
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    # the profiler writes ts in microseconds from baseTimeNanoseconds
    # (absolute where it writes no base)
    rec = recorded()
    doc['traceEvents'] += _chrome_events(
        Recorded([s for s in rec.spans if s.start_ns >= t0],
                 [c for c in rec.counts if c.t_ns >= t0]),
        int(doc.get('baseTimeNanoseconds', 0)))
    with open(path, 'w') as f:
        json.dump(doc, f, default=str)


def _wait_for(sync: Any) -> None:
    """Wait until the work that produced `sync` is done: a CUDA tensor's
    stream (the current stream of its device), or every tensor of a
    list, tuple or dict."""
    import torch
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
    import torch
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
