"""What the readers of the program's own spans and counters share
(`opental_torch.utils.profiling`, recording while the traced window's
profiler is on): the recording, the sum of a counter inside the traced
window, and the share of the window in which the card was idle while the
main thread was inside a layer's spans. A program older than the recorder
reads as nothing (None), so its traced runs leave these metrics out."""

from __future__ import annotations

import bisect
import threading
from typing import List, Optional, Tuple


def recorded():
    """The program's recording, or None where the program has no
    recorder."""
    try:
        from opental_torch.utils.profiling import recorded
    except ImportError:
        return None
    return recorded()


def counted(run, name: str) -> Optional[float]:
    """Counter `name` summed over the counts made inside the traced
    window (None where none was made)."""
    rec = recorded()
    if rec is None:
        return None
    w0, w1 = run.trace.window_ns
    found = [c.n for c in rec.counts if c.name == name and w0 <= c.t_ns < w1]
    return sum(found) if found else None


def _merged(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def idle_in_pct(run, prefixes: Tuple[str, ...]) -> Optional[float]:
    """The part of the traced window in which a device idle gap overlaps
    the union of the main thread's closed spans whose name starts with
    one of `prefixes` (their children lie inside them), in % of the
    window; None where the main thread recorded no such span in it."""
    rec = recorded()
    w0, w1 = run.trace.window_ns
    if rec is None or w1 <= w0:
        return None
    main = threading.main_thread().ident
    spans = _merged([(max(s.start_ns, w0), min(s.end_ns, w1))
                     for s in rec.spans
                     if s.thread == main and s.end_ns is not None
                     and s.name.startswith(prefixes)
                     and s.end_ns > w0 and s.start_ns < w1])
    if not spans:
        return None
    gaps = sorted(run.trace.gaps)
    starts = [a for a, _ in gaps]
    idle = 0
    for s, e in spans:
        i = max(bisect.bisect_right(starts, s) - 1, 0)
        while i < len(gaps) and gaps[i][0] < e:
            a, b = gaps[i]
            idle += max(0, min(b, e) - max(a, s))
            i += 1
    return 100.0 * idle / (w1 - w0)
