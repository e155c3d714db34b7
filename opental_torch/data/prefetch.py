"""Background input prefetch onto the device.

Counterpart of `opental_tpu/data/prefetch.py` (the reference's 4
DataLoader workers, AFSD/thumos14/train.py:345). A thread assembles batch
i+1 while step i runs: it pins each numpy array and copies it to the
card with `non_blocking=True` on a side stream, so the copy overlaps the
step's kernels; the consumer's stream waits on the copy's event before
the batch is used. On the CPU the arrays are wrapped as they are.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterable, Iterator

import numpy as np
import torch

_DONE = object()


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
    `depth` batches ahead on a background thread. An exception in the
    thread re-raises at the consumer; leaving the loop early stops the
    thread."""
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()
    cuda = device.type == 'cuda'

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        stream = torch.cuda.Stream(device) if cuda else None
        try:
            for batch in batches:
                if cuda:
                    with torch.cuda.stream(stream):
                        placed = to_device(batch, device)
                        ready = torch.cuda.Event()
                        ready.record(stream)
                else:
                    placed, ready = to_device(batch, device), None
                if not put((placed, ready)):
                    return
        except BaseException as e:  # noqa: BLE001 - re-raised below
            put((_DONE, e))
            return
        put((_DONE, None))

    thread = threading.Thread(target=worker, daemon=True,
                              name='opental-torch-prefetch')
    thread.start()
    try:
        while True:
            placed, ready = q.get()
            if placed is _DONE:
                if ready is not None:
                    raise ready
                return
            if ready is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(ready)
                for t in placed.values():
                    t.record_stream(current)
            yield placed
    finally:
        stop.set()
        thread.join(timeout=10)
