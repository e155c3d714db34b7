"""Online (streaming) inference over one video stream.

Counterpart of `opental_tpu/infer/streaming.py`. Frames arrive in chunks
(a live capture, a decoder pipe); each sliding window runs as soon as
its frames exist, and `finalize()` gives the offline pipeline's
proposals for the whole stream: the same window offsets (with the
irregular tail window, test.py:48-56) and the same post-processing
(`InferencePipeline.post_video`: host soft-NMS or the fused device
post).

Memory is bounded: frames that no later window can read are trimmed as
soon as a chunk has been consumed (at most `clip_length` frames stay
resident between calls), and every forward is one fixed (max_batch,
clip, H, W, C) uint8 batch through `ingest_windows` and the model,
zero-padded past its windows.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from opental_torch.data import transforms
from opental_torch.infer.decode import DecodedWindows
from opental_torch.infer.pipeline import (InferencePipeline, _cat_decoded,
                                          _require_u8, _slice_decoded,
                                          ingest_windows, window_offsets)


class StreamingSession:
    """Incremental window-batched inference for one video stream.

    Wraps an `InferencePipeline` with the per-window semantics (no
    shared backbone, no RGB + flow fusion) and runs its forward + decode
    on fixed-shape uint8 batches.

    Usage::

        sess = StreamingSession(pipe, sample_fps=10.0)
        for chunk in frame_source:       # (n, H, W, C) uint8 chunks
            sess.feed(chunk)
        proposals = sess.finalize()      # == pipe.run_video(whole)
    """

    def __init__(self, pipe: InferencePipeline, sample_fps: float,
                 max_batch: int = 8, name: str = 'stream'):
        if pipe.shared_backbone:
            raise ValueError('streaming runs the per-window semantics, not '
                             'the shared backbone')
        if pipe.flow_model is not None:
            raise ValueError('streaming is single-stream (no RGB + flow '
                             'fusion)')
        if pipe.mesh is not None and max_batch % pipe.mesh.size:
            # each forward's windows split evenly over the mesh
            # (`opental_tpu/infer/streaming.py:55-57`)
            raise ValueError(f'max_batch {max_batch} must be a multiple of '
                             f'the mesh size {pipe.mesh.size}')
        self.pipe = pipe
        self.sample_fps = sample_fps
        self.max_batch = max_batch
        self.name = name
        self.clip = pipe.clip_length
        self.stride = pipe.stride

        # frame ring: _buf[i] holds stream frame _base + i
        self._buf: Optional[np.ndarray] = None
        self._base = 0                 # stream index of _buf[0]
        self._t = 0                    # total frames received
        self._next_off = 0             # next regular window offset
        self._queue: List[Tuple[np.ndarray, int]] = []  # (window, valid)
        self._windows_run = 0
        self._got: List[DecodedWindows] = []
        self._final: Optional[List[Dict[str, Any]]] = None

    # ---- frame buffer -------------------------------------------------

    def _append(self, frames: np.ndarray) -> None:
        n = frames.shape[0]
        used = self._t - self._base
        if self._buf is None:
            cap = max(4 * self.clip, 2 * n)
            self._buf = np.empty((cap,) + frames.shape[1:], np.uint8)
        elif used + n > self._buf.shape[0]:
            cap = max(2 * self._buf.shape[0], used + n)
            grown = np.empty((cap,) + self._buf.shape[1:], np.uint8)
            grown[:used] = self._buf[:used]
            self._buf = grown
        self._buf[used:used + n] = frames
        self._t += n

    def _trim(self) -> None:
        """Drop frames no later window can read: every regular window
        from `_next_off` on, and the tail window, which starts at
        (final count - clip) >= _t - clip for any final count >= _t."""
        keep_from = min(self._next_off, max(0, self._t - self.clip))
        if keep_from > self._base:
            used = self._t - self._base
            drop = keep_from - self._base
            self._buf[:used - drop] = self._buf[drop:used]
            self._base = keep_from

    def _window(self, off: int, valid_end: int) -> np.ndarray:
        """The uint8 window at stream offset `off`, zero past
        `valid_end`; the caller passes its frames-valid with it, and
        `ingest_windows` zeroes those frames after normalization."""
        lo = off - self._base
        avail = min(self.clip, max(0, valid_end - off))
        out = np.zeros((self.clip,) + self._buf.shape[1:], np.uint8)
        out[:avail] = self._buf[lo:lo + avail]
        return out

    # ---- forward ------------------------------------------------------

    def _run(self, take: List[Tuple[np.ndarray, int]]) -> None:
        """One forward of max_batch windows: the batch is always full
        (zero windows with frames-valid 0 past the real ones), so every
        forward of the stream has one shape."""
        n = len(take)
        batch = np.zeros((self.max_batch, self.clip)
                         + self._buf.shape[1:], np.uint8)
        valid = np.zeros((self.max_batch,), np.int64)
        for i, (w, v) in enumerate(take):
            batch[i] = w
            valid[i] = v
        pipe = self.pipe
        clips = ingest_windows(pipe._to_device(batch),
                               pipe._to_device(valid))
        self._got.append(_slice_decoded(pipe.forward_decode(clips), 0, n))
        self._windows_run += n

    def _drain(self, flush: bool = False) -> None:
        while len(self._queue) >= self.max_batch or (flush and self._queue):
            take = self._queue[:self.max_batch]
            self._queue = self._queue[self.max_batch:]
            self._run(take)

    # ---- public API ---------------------------------------------------

    @property
    def frames_received(self) -> int:
        return self._t

    @property
    def windows_processed(self) -> int:
        return self._windows_run

    @property
    def frames_resident(self) -> int:
        """Frames held now (at most clip_length after each feed)."""
        return self._t - self._base

    def feed(self, frames: np.ndarray) -> int:
        """Add a chunk of (n, H, W, C) uint8 frames (any n >= 1; frames
        larger than the pipeline's crop are center-cropped). Returns the
        number of windows whose forward ran during this call. Float
        frames raise TypeError (`_require_u8`)."""
        if self._final is not None:
            raise RuntimeError('session already finalized')
        _require_u8(frames, 'stream frames')
        before = self._windows_run
        self._append(transforms.center_crop(frames, self.pipe.crop_size))
        while self._next_off + self.clip <= self._t:
            self._queue.append((self._window(self._next_off, self._t),
                                self.clip))
            self._next_off += self.stride
        self._drain()
        self._trim()
        return self._windows_run - before

    def _results(self, offsets: List[int]) -> List[Dict[str, Any]]:
        return self.pipe.post_video(_cat_decoded(self._got), offsets,
                                    self.sample_fps, self.name)

    def preview(self) -> List[Dict[str, Any]]:
        """Proposals from the windows completed so far: a mid-stream
        snapshot (post-processing over the partial window set; the
        session's state is not consumed, and `finalize()` still gives
        the whole stream's result)."""
        if self._final is not None:
            raise RuntimeError('session already finalized')
        if self._windows_run == 0:
            return []
        return self._results([i * self.stride
                              for i in range(self._windows_run)])

    def finalize(self, sample_count: Optional[int] = None
                 ) -> List[Dict[str, Any]]:
        """Run the remaining windows (the irregular tail window and the
        zero-padded short-stream window among them) and post-process the
        whole stream. Returns the proposals `InferencePipeline.run_video`
        gives for the whole video; idempotent."""
        if self._final is not None:
            return self._final
        if self._t == 0:
            raise RuntimeError('no frames were fed')
        count = self._t if sample_count is None else sample_count
        if count < self._t:
            raise ValueError('sample_count below the frames received: feed '
                             'fewer frames instead')
        offsets = window_offsets(count, self.clip, self.stride)
        # feed() ran every stride-aligned offset below _next_off; what is
        # left is the irregular tail window (not stride-aligned, so never
        # queued, and below _next_off whenever the last regular window
        # ends past it) and, when count > _t, regular offsets whose
        # frames never all arrived
        for off in offsets:
            if off % self.stride != 0 or off >= self._next_off:
                self._queue.append((self._window(off, self._t),
                                    min(self.clip, max(0, self._t - off))))
        self._drain(flush=True)
        self._final = self._results(offsets)
        return self._final
