"""The traced run: the device profiler around a window, the benchmark's
own host spans, the capture of the kernels' custom-op calls, and the
reduction of the device trace to what the per-layer readers take.

The profiler is driven through its low-level interface and its raw
events are read directly (one pass, no per-event Python objects kept),
so that a window with a million kernel launches reduces in seconds.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, Iterator, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

POOL_FWD_OP = 'opental::boundary_max_pool_fwd'
POOL_BWD_OP = 'opental::boundary_max_pool_bwd'
POOL_FWD_KERNEL = 'pool_fwd_kernel'
POOL_BWD_KERNEL = 'pool_bwd_kernel'
COPIES = ('Memcpy', 'Memset')     # device work that is not a kernel
TOP = 10


class Spans:
    """The benchmark's host spans around the calls it makes into each
    layer, kept in memory: (start ns, end ns, name) on the host's epoch
    clock, which the device trace's timestamps share. Two clock reads a
    span, so they stay on in untraced runs too."""

    def __init__(self):
        self.done: List[Tuple[int, int, str]] = []
        self._open: List[Tuple[str, int]] = []

    def enter(self, name: str) -> None:
        self._open.append((name, time.time_ns()))

    def exit(self) -> None:
        name, t0 = self._open.pop()
        self.done.append((t0, time.time_ns(), name))

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        self.enter(name)
        try:
            yield
        finally:
            self.exit()


class OpCalls(TorchDispatchMode):
    """Records the inputs of every boundary-pool custom-op call made
    while it is entered: the forward's x shape and item size, segments
    (a reference, not a copy), level table and argmax flag; the
    backward's g shape and item size and T."""

    def __init__(self):
        super().__init__()
        self.fwd: List[Dict[str, Any]] = []
        self.bwd: List[Dict[str, Any]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.name() if hasattr(func, 'name') else ''
        if name.startswith(POOL_FWD_OP):
            x, seg, level_t, level_k, with_argmax = args[:5]
            if x.numel() and seg.shape[1]:
                self.fwd.append({'x_shape': tuple(x.shape),
                                 'itemsize': x.element_size(),
                                 'segments': seg,
                                 'levels': tuple(zip(level_t, level_k)),
                                 'with_argmax': bool(with_argmax)})
        elif name.startswith(POOL_BWD_OP):
            _, g, t_len = args[:3]
            if g.numel():
                self.bwd.append({'g_shape': tuple(g.shape),
                                 'itemsize': g.element_size(),
                                 't_len': int(t_len)})
        return func(*args, **kwargs)


class Profiler:
    """Device activity profiling (CUDA kernels, copies and sets) between
    `start` and `stop`. Host operators are not recorded: at a few
    microseconds each they would slow the launch-bound host paths
    (soft-NMS, the training step) several fold; the benchmark's own
    spans (`Spans`) name the host's activity instead."""

    def __init__(self):
        self.events = None

    def start(self) -> None:
        from torch._C._profiler import _ExperimentalConfig
        from torch.autograd import (ProfilerActivity, ProfilerConfig,
                                    ProfilerState, _enable_profiler,
                                    _prepare_profiler)
        self._cfg = ProfilerConfig(ProfilerState.KINETO, False, False,
                                   False, False, False,
                                   _ExperimentalConfig())
        self._acts = {ProfilerActivity.CUDA}
        _prepare_profiler(self._cfg, self._acts)
        _enable_profiler(self._cfg, self._acts)

    def stop(self) -> None:
        from torch.autograd import _disable_profiler
        self.events = _disable_profiler().events()


def _union_seconds(intervals: List[Tuple[int, int]]) -> Tuple[
        int, List[Tuple[int, int]]]:
    """(covered ns, the gaps between the merged intervals)."""
    covered, gaps = 0, []
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                covered += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        covered += cur_e - cur_s
    return covered, gaps


class Reduced:
    """What the readers take from one traced window: the device events
    of the window span, their union (busy), the gaps between them, and
    the benchmark's spans."""

    def __init__(self, events, spans: Spans, window: str = 'window'):
        is_cuda = torch.autograd.DeviceType.CUDA
        found = [(s, e) for s, e, n in spans.done if n == window]
        if not found:
            raise RuntimeError(f'no {window} span')
        w0, w1 = self.window_ns = found[-1]
        self.window_s = (w1 - w0) / 1e9
        self.spans = sorted(spans.done)
        host_names, device = set(), []
        for e in events:
            name = e.name()
            if e.device_type() == is_cuda:
                device.append((name, e.start_ns(), e.duration_ns()))
            else:
                host_names.add(name)
        # a device event named as a host event is the card's copy of a
        # host annotation, not work
        self.all_device = [d for d in device if d[0] not in host_names]
        inside = [(n, s, d) for n, s, d in self.all_device if w0 <= s < w1]
        self.launches = sum(1 for n, _, _ in inside
                            if not n.startswith(COPIES))
        busy, gaps = _union_seconds([(s, min(s + d, w1))
                                     for _, s, d in inside])
        self.busy_s = busy / 1e9
        if inside:
            first = min(s for _, s, _ in inside)
            last = max(s + d for _, s, d in inside)
            gaps = [(w0, first)] + gaps + [(min(last, w1), w1)]
        else:
            gaps = [(w0, w1)]
        self.gaps = [(a, b) for a, b in gaps if b > a]

    def device_ops(self) -> List[List[Any]]:
        """The TOP device operations by time in the window: [name,
        seconds]."""
        tot: Dict[str, int] = {}
        w0, w1 = self.window_ns
        for n, s, d in self.all_device:
            if w0 <= s < w1:
                tot[n] = tot.get(n, 0) + d
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:TOP]
        return [[n[:200], d / 1e9] for n, d in top]

    def _host_at(self, t: int) -> str:
        """The innermost benchmark span open at time t."""
        name = '(no span)'
        for s, e, n in self.spans:
            if s > t:
                break
            if e >= t:
                name = n
        return name

    def idle_gaps(self) -> List[List[Any]]:
        """The TOP longest idle gaps of the device in the window, each
        named by what the host was doing at its middle: [name, seconds]."""
        top = sorted(self.gaps, key=lambda g: g[0] - g[1])[:TOP]
        return [[self._host_at((a + b) // 2), (b - a) / 1e9]
                for a, b in top]

    def kernel_durations(self, needle: str) -> List[float]:
        """Seconds of each kernel of the whole trace whose name holds
        `needle`, in start order."""
        return [d / 1e9 for n, s, d in sorted(self.all_device,
                                               key=lambda x: x[1])
                if needle in n]
