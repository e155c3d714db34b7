"""Background prefetch on a host thread.

Counterpart of `opental_tpu/data/prefetch.py` (the reference's 4
DataLoader workers, AFSD/thumos14/train.py:345). `prefetch_items` is the
JAX package's `prefetch(iterable, transform, depth)`: a thread computes
`transform(item)` `depth` items ahead (loading the next video from disk,
staging the next frame buffer) while the consumer works on the current
one. `prefetch` builds the training input on it: the thread pins each
numpy array of a batch and copies it to the card with `non_blocking=True`
on a side stream, so the copy overlaps the step's kernels; the
consumer's stream waits on the copy's event before the batch is used. On
the CPU the arrays are wrapped as they are. Spans (`utils/profiling`):
`loader.place` (pin and copy issue, on the thread) and `loader.wait`
(the consumer blocked on the queue).
"""

from __future__ import annotations

import contextlib
import queue
import threading
from typing import Any, Callable, Dict, Iterable, Iterator, Optional

import numpy as np
import torch

from opental_torch.utils import profiling

_DONE = object()


def prefetch_items(iterable: Iterable[Any],
                   transform: Optional[Callable[[Any], Any]] = None,
                   depth: int = 2, wait: Optional[str] = None
                   ) -> Iterator[Any]:
    """Yield `transform(item)` (or the item) for each item, computed
    `depth` items ahead on a background thread that starts at once. An
    exception in the thread re-raises at the consumer; leaving the loop
    early (or closing the iterator) stops the thread. `wait` names the
    span of the consumer's time blocked on the queue (its request id
    the item's index)."""
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterable:
                if not put(item if transform is None else transform(item)):
                    return
        except BaseException as e:  # noqa: BLE001 - re-raised below
            put((_DONE, e))
            return
        put((_DONE, None))

    thread = threading.Thread(target=worker, daemon=True,
                              name='opental-torch-prefetch')
    profiling.refresh()
    thread.start()

    def consume():
        try:
            taken = 0
            while True:
                with (profiling.span(wait, taken) if wait
                      else profiling.OFF):
                    item = q.get()
                taken += 1
                if isinstance(item, tuple) and len(item) == 2 \
                        and item[0] is _DONE:
                    if item[1] is not None:
                        raise item[1]
                    return
                yield item
        finally:
            stop.set()
            thread.join(timeout=10)

    return consume()


def to_device(batch: Dict[str, np.ndarray], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    """numpy batch -> tensors on `device` (pinned, non-blocking copies on
    the current stream for a card)."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == 'cuda':
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


def prefetch(batches: Iterable[Dict[str, np.ndarray]],
             device: torch.device, depth: int = 2
             ) -> Iterator[Dict[str, torch.Tensor]]:
    """Yield each numpy batch as tensors on `device`, assembled and copied
    `depth` batches ahead on a background thread (`prefetch_items`)."""
    cuda = device.type == 'cuda'
    stream = torch.cuda.Stream(device) if cuda else None

    def place(batch):
        with profiling.span('loader.place'):
            if not cuda:
                return to_device(batch, device), None
            with torch.cuda.stream(stream):
                placed = to_device(batch, device)
                ready = torch.cuda.Event()
                ready.record(stream)
            return placed, ready

    with contextlib.closing(prefetch_items(batches, place, depth,
                                           wait='loader.wait')) as items:
        for placed, ready in items:
            if ready is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(ready)
                for t in placed.values():
                    t.record_stream(current)
            yield placed
