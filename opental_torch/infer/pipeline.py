"""Window-batched video inference pipeline (PyTorch).

Counterpart of `opental_tpu/infer/pipeline.py`; reference
AFSD/thumos14/test.py:203-256. Windows of 256 frames at stride 128 run
through the model (and, for two-stream fusion, the flow model, with every
head averaged) and are decoded in batches; post-processing runs either
fused on the device (per-class top-k preselect + batched soft-NMS, the
default) or on the host (numpy soft-NMS per class, the reference's
semantics; with `device_nms` each class's block on the device).

Ingest modes, as the JAX package's (`run_videos` routes):
* device ingest (default): a video's raw uint8 frames go to the device
  once and windows are gathered and normalized there
  (`device_windows`). Over a dataset (`run_videos_ingest`) consecutive
  videos pack into one frame buffer of `frames_capacity` frames per
  flush, staged on a background thread while the previous flush
  computes, windows batch into full `max_batch` forwards across video
  boundaries, and a flush's videos are post-processed while the next
  flush's forwards run;
* host staging (`device_ingest=False`): windows are cut on the host,
  as float32 per video (`stack_windows`) or as uint8 packed across
  videos (`stack_windows_u8` + `ingest_windows`).
Every mode gives each window the same input, so the proposals agree.

Shared backbone (`shared_backbone=True`, `testing.shared_backbone`): the
backbone runs once over a span of `shared_group` (4) consecutive windows,
stride * (k - 1) + clip + 8 frames, and each window's Mixed_4f / Mixed_5c
slice (at lo // 4, lo // 8 of its span) goes through the pyramid and
heads. Per video (`_run_video_shared`) or packed across videos
(`run_videos_shared`), with the spans gathered from the staged uint8
buffer on the device. Windows then see their real temporal context at
their edges where the per-window forward sees zero padding
(`PARITY.md` "Known deviations"), so this mode is held against the JAX
package's shared path, not against the per-window one.
Output JSON matches test.py:254-256.
"""

from __future__ import annotations

import contextlib
import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from opental_torch import resolve_device
from opental_torch.data import transforms
from opental_torch.data.prefetch import prefetch_items
from opental_torch.infer.decode import (DecodedWindows, decode_windows,
                                        fuse_streams)
from opental_torch.ops.nms import soft_nms_device, soft_nms_numpy
from opental_torch.parallel.mesh import Mesh, gather_rows
from opental_torch.utils import profiling


def window_offsets(sample_count: int, clip_length: int,
                   stride: int) -> List[int]:
    """Sliding-window offsets incl. the tail window (test.py:48-56)."""
    if sample_count < clip_length:
        return [0]
    offsets = list(range(0, sample_count - clip_length + 1, stride))
    if (sample_count - clip_length) % stride:
        offsets.append(sample_count - clip_length)
    return offsets


def _bucket(n: int, granule: int = 8) -> int:
    """n rounded up to a multiple of granule (at least one granule)."""
    return max(granule, ((n + granule - 1) // granule) * granule)


def _require_u8(data: np.ndarray, what: str = 'frames') -> None:
    """uint8-staging intake guard: numpy assignment of float frames into
    a uint8 buffer truncates silently (127.5 -> 127, which normalizes to
    -0.0039 instead of the reference pad's exact 0.0). Callers with float
    videos must ship raw uint8 + a padded sample_count instead."""
    if data.dtype != np.uint8:
        raise TypeError(
            f'uint8 staging requires raw uint8 {what}, got {data.dtype}; '
            'float frames would be silently truncated: ship the raw '
            'uint8 npy (pad via sample_count, not host pad values)')


def stage_frames(buf: Union[np.ndarray, torch.Tensor],
                 chunk_frames: Optional[int] = None,
                 pad_to: Optional[int] = None,
                 device: Optional[Union[str, torch.device]] = 'cpu'
                 ) -> torch.Tensor:
    """Host (T, ...) frames -> a (pad_to or T, ...) tensor on `device`,
    zero past T. The padding is written on the device, so only the real
    frames cross the link; to a card the copy is one non-blocking copy
    from pinned memory (pass a pinned tensor to save the extra host copy
    that pinning a numpy buffer takes) on the current stream.
    `chunk_frames` is the JAX signature's chunk size, a hint only: the
    whole buffer goes in one copy."""
    del chunk_frames
    src = torch.from_numpy(np.ascontiguousarray(buf)) \
        if isinstance(buf, np.ndarray) else buf
    n = src.shape[0]
    if pad_to is not None and pad_to < n:
        raise ValueError(f'pad_to {pad_to} < frames {n}')
    out = torch.empty((n if pad_to is None else pad_to,) + src.shape[1:],
                      dtype=src.dtype, device=device)
    out[n:].zero_()
    cuda = out.is_cuda
    if cuda and not src.is_pinned():
        src = src.pin_memory()
    out[:n].copy_(src, non_blocking=cuda)
    return out


def ingest_windows(clips_u8: torch.Tensor, valid: torch.Tensor
                   ) -> torch.Tensor:
    """(Wc, clip, H, W, C) uint8 windows -> (Wc, C, clip, H, W) float32 in
    [-1, 1], the model's layout, with frames >= valid (Wc,) zeroed after
    normalization (the reference's zero pad, test.py:67-76)."""
    steps = torch.arange(clips_u8.shape[1], device=clips_u8.device)
    keep = steps < valid.reshape(-1, 1)                     # (Wc, clip)
    # divide by a tensor on the device: PyTorch turns a division by a
    # Python number on the card into a multiplication by its reciprocal,
    # one ulp off the host path's (and the reference's) true division.
    # `full` fills it on the device (torch.tensor would copy from the
    # host and synchronize the stream)
    scale = torch.full((), 255.0, device=clips_u8.device)
    x = (clips_u8.permute(0, 4, 1, 2, 3).float() / scale) * 2.0 - 1.0
    return torch.where(keep[:, None, :, None, None], x, 0.0).contiguous()


def device_windows(video_u8: torch.Tensor, offsets: torch.Tensor,
                   frames_valid: Union[int, torch.Tensor],
                   clip_length: int) -> torch.Tensor:
    """Window gather + normalization on the video's device.

    video_u8: (Tp, H, W, C) uint8 holding every window's frames; offsets:
    (Wc,) int64; frames >= frames_valid (a scalar, or (Wc,) when the
    buffer packs several videos: a window whose tail reads the next
    video's frames zeroes them) are zero after normalization. Returns
    (Wc, C, clip, H, W) float32 in [-1, 1].
    """
    steps = torch.arange(clip_length, device=video_u8.device)
    # `frames_valid - offsets`, not as_tensor(frames_valid): a Python
    # number copied to the card would synchronize the host per batch
    return ingest_windows(video_u8[offsets[:, None] + steps],
                          frames_valid - offsets)


def stack_windows(data: np.ndarray, offsets: Sequence[int],
                  clip_length: int) -> np.ndarray:
    """(T, H, W, C) uint8 video -> (W, clip, H, W, C) float32 in [-1, 1];
    zero-pads short tails (test.py:67-76). (The JAX package pads the
    window count to a bucket to bound its recompiles; nothing here needs
    it.)"""
    t, h, w, c = data.shape
    out = np.zeros((len(offsets), clip_length, h, w, c), np.float32)
    for i, off in enumerate(offsets):
        clip = data[off:off + clip_length].astype(np.float32)
        out[i, :clip.shape[0]] = (clip / 255.0) * 2.0 - 1.0
    return out


def stack_windows_u8(data: np.ndarray, offsets: Sequence[int],
                     clip_length: int) -> Tuple[np.ndarray, np.ndarray]:
    """stack_windows' uint8 twin for the host-staged packed path (4x
    fewer bytes over the link): ((W, clip, H, W, C) uint8, (W,) int32
    frames-valid); `ingest_windows` normalizes on the device."""
    _require_u8(data)
    t, h, w, c = data.shape
    out = np.zeros((len(offsets), clip_length, h, w, c), np.uint8)
    valid = np.zeros((len(offsets),), np.int32)
    for i, off in enumerate(offsets):
        clip = data[off:off + clip_length]
        out[i, :clip.shape[0]] = clip
        valid[i] = clip.shape[0]
    return out, valid


def snapped_offsets(sample_count: int, clip_length: int, stride: int
                    ) -> List[int]:
    """`window_offsets` with the irregular tail offset snapped up to a
    multiple of 8, so that its feature slices stay on the stride-4 and
    stride-8 grids of its span; the overhang reads the zero pad, as a
    zero-padded tail window does."""
    return [o if o % 8 == 0 else ((o + 7) // 8) * 8
            for o in window_offsets(sample_count, clip_length, stride)]


def span_plan(offsets: Sequence[int], k: int
              ) -> Tuple[np.ndarray, np.ndarray, List[int]]:
    """Groups of k consecutive windows: (bases (G,) the first window's
    offset, local (G, k) each window's offset in its span, counts (G,)
    the real windows per group). A short tail group repeats its last
    window; the repeats are dropped after decode."""
    n = len(offsets)
    n_groups = -(-n // k)
    bases = np.zeros((n_groups,), np.int64)
    local = np.zeros((n_groups, k), np.int64)
    for g in range(n_groups):
        grp = np.asarray(offsets[g * k:(g + 1) * k], np.int64)
        bases[g] = grp[0]
        local[g, :len(grp)] = grp - grp[0]
        local[g, len(grp):] = grp[-1] - grp[0]
    counts = [k] * (n_groups - 1) + [n - (n_groups - 1) * k]
    return bases, local, counts


def window_features(feats: Dict[str, torch.Tensor], local: torch.Tensor,
                    clip_length: int) -> Dict[str, torch.Tensor]:
    """Each window's slice of its span's backbone features: Mixed_4f
    (b, C, span / 4, h, w) from step lo // 4 and Mixed_5c from lo // 8,
    for the (b, k) span-local offsets lo; returns the (b * k) windows'
    features, span-major, gathered on the features' device."""
    out = {}
    for key, stride in (('Mixed_4f', 4), ('Mixed_5c', 8)):
        f = feats[key].transpose(1, 2)                  # (b, t, C, h, w)
        rows = (local // stride)[..., None] + torch.arange(
            clip_length // stride, device=f.device)     # (b, k, w)
        g = f[torch.arange(f.shape[0], device=f.device)[:, None, None],
              rows]                                     # (b, k, w, C, h, w)
        out[key] = g.flatten(0, 1).transpose(1, 2)
    return out


def _cat_decoded(parts: Sequence[DecodedWindows]) -> DecodedWindows:
    def cat(field):
        xs = [getattr(p, field) for p in parts]
        return None if xs[0] is None else (
            xs[0] if len(xs) == 1 else torch.cat(xs))
    return DecodedWindows(*(cat(f) for f in DecodedWindows._fields))


def _slice_decoded(dec: DecodedWindows, lo: int, hi: int
                   ) -> DecodedWindows:
    return DecodedWindows(*(None if a is None else a[lo:hi] for a in dec))


def _pad_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """x with zero rows appended up to n rows."""
    if x.shape[0] == n:
        return x
    return torch.cat([x, x.new_zeros((n - x.shape[0],) + x.shape[1:])])


def _gather_decoded(mesh: Mesh, dec: DecodedWindows) -> DecodedWindows:
    return DecodedWindows(*(None if a is None else gather_rows(mesh, a)
                            for a in dec))


STREAMS = ('rgb', 'flow')


def fused_forward(models: Sequence[torch.nn.Module],
                  inputs: Sequence[torch.Tensor],
                  forward: Optional[Callable] = None) -> Dict[str, Any]:
    """The RGB model's outputs on inputs[0] or, with a flow model and its
    input second, both streams' outputs averaged head by head
    (`fuse_streams`). The streams run in that order on the current
    stream; `forward(model, x)` replaces `model(x)` (the shared
    backbone's path). Spans `stream.rgb`, `stream.flow` and `fuse`;
    counters `stream.rgb_ms` and `stream.flow_ms`, each stream's time on
    the card (`profiling.device_ms`)."""
    outs = []
    for name, model, x in zip(STREAMS, models, inputs):
        with profiling.span('stream.' + name), \
                profiling.device_ms(f'stream.{name}_ms', x.device):
            outs.append(model(x) if forward is None else forward(model, x))
    if len(outs) == 1:
        return outs[0]
    with profiling.span('fuse'):
        return fuse_streams(*outs)


def _new_video(name, offsets, fps, **extra) -> Dict[str, Any]:
    """Scheduler record of an open video: decoded rows arrive in `got`
    until `need` reaches 0."""
    return dict(name=name, offsets=offsets, fps=fps, need=len(offsets),
                got=[], **extra)


def _route_rows(vids: List[Dict[str, Any]], dec: DecodedWindows,
                n_rows: int, first: int = 0) -> int:
    """Hand the first `n_rows` decoded rows to the open videos in FIFO
    order from `vids[first]`; returns the index of the first video still
    open."""
    r, vi = 0, first
    while r < n_rows:
        vid = vids[vi]
        take = min(vid['need'], n_rows - r)
        vid['got'].append(_slice_decoded(dec, r, r + take))
        vid['need'] -= take
        r += take
        if vid['need'] == 0:
            vi += 1
    return vi


class InferencePipeline:
    """Forward + decode over window batches for one model, or for an RGB
    and a flow model fused (`flow_model`, the 2-channel BDNet: the two
    run in sequence on the same stream and every head is averaged).

    The models (port BDNets with their weights) move to `device`, the
    card unless the caller asks for the CPU. device_post=True (default)
    runs the fused device post-processing, False the host path, where
    device_nms=True runs each class's soft-NMS on the device.
    device_ingest=True (default) gathers windows from the raw frames on
    the device, False stages them on the host. n_candidates bounds the
    per-class device preselect (2048, the THUMOS CLI's default).
    use_gcpl negates the class outputs before decode (GCPL's scores are
    negative distances). shared_backbone=True runs one backbone pass per
    span of `shared_group` windows, at most `shared_max_groups` spans per
    forward (the JAX package's values).

    mesh (`parallel.mesh.make_mesh()`): every rank runs the same host
    plan and stages the same frame buffers (the weights and frames are
    replicated), keeps its contiguous share of each forward's windows
    (of each shared forward's spans), padded with zero rows to a
    multiple of the mesh size, and gathers the decoded rows back in
    order (`_sharded`), so post-processing sees the single-device rows
    and every rank returns the same proposals. The device is the
    mesh's. As in the JAX package, RGB + flow fusion on a mesh needs
    device ingest, the shared backbone is single-stream on a mesh, and
    every window batch (`max_batch`) divides over the mesh.
    """

    shared_group = 4
    shared_max_groups = 48

    def __init__(self, model: torch.nn.Module, clip_length: int = 256,
                 stride: int = 128, crop_size: int = 96,
                 conf_thresh: float = 0.01, top_k: int = 5000,
                 nms_sigma: float = 0.5, use_edl: bool = False,
                 os_head: bool = False, use_gcpl: bool = False,
                 evidence: str = 'exp',
                 flow_model: Optional[torch.nn.Module] = None,
                 device_nms: bool = False, device_post: bool = True,
                 n_candidates: int = 2048, device_ingest: bool = True,
                 shared_backbone: bool = False,
                 device: Optional[Union[str, torch.device]] = None,
                 mesh: Optional[Mesh] = None):
        if mesh is not None:
            if flow_model is not None and not device_ingest:
                raise ValueError('mesh + two-stream fusion requires '
                                 'device_ingest (twin-buffer ingest)')
            if flow_model is not None and shared_backbone:
                raise ValueError('shared_backbone fusion runs are '
                                 'single-device')
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f'device {device} is not the mesh\'s '
                                 f'{mesh.device}')
            device = mesh.device
        self.mesh = mesh
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.flow_model = (None if flow_model is None
                           else flow_model.to(self.device).eval())
        self.clip_length = clip_length
        self.stride = stride
        self.crop_size = crop_size
        self.conf_thresh = conf_thresh
        self.top_k = top_k
        self.nms_sigma = nms_sigma
        self.use_edl = use_edl
        self.os_head = os_head
        self.use_gcpl = use_gcpl
        self.evidence = evidence
        self.num_classes = model.head_classes
        self.device_nms = device_nms
        self.device_post = device_post
        self.n_candidates = n_candidates
        self.device_ingest = device_ingest
        self.shared_backbone = shared_backbone

    # ------------------------------------------------------------ forward

    def _decode(self, out: Dict[str, Any]) -> DecodedWindows:
        return decode_windows(
            out, self.clip_length, use_edl=self.use_edl,
            os_head=self.os_head,
            score_func='dirichlet' if self.use_edl else 'softmax',
            evidence=self.evidence, negate_conf=self.use_gcpl)

    def _check_batch(self, max_batch: int) -> None:
        """A window batch divides over the mesh (JAX: `pipeline.py:378`,
        `:729`)."""
        if self.mesh is not None and max_batch % self.mesh.size:
            raise ValueError(f'max_batch {max_batch} must divide over the '
                             f'mesh of {self.mesh.size}')

    def _sharded(self, decode, rows: Sequence[Any], per_row: int = 1
                 ) -> DecodedWindows:
        """decode(*rows) of n rows (the leading axis of each tensor in
        `rows`; other entries pass as they are), decoding per_row windows
        per row. On a mesh each rank decodes its contiguous share of the
        rows, padded with zero rows (zero frames: frames-valid 0) to a
        multiple of the mesh size, and the decoded windows are gathered
        back in rank order."""
        if self.mesh is None:
            return decode(*rows)
        n = next(r.shape[0] for r in rows
                 if isinstance(r, torch.Tensor) and r.dim())
        w = self.mesh.size
        per = -(-n // w)
        lo = self.mesh.rank * per
        local = [_pad_rows(r, per * w)[lo:lo + per]
                 if isinstance(r, torch.Tensor) and r.dim() else r
                 for r in rows]
        with torch.inference_mode():
            return _slice_decoded(_gather_decoded(self.mesh,
                                                  decode(*local)),
                                  0, n * per_row)

    def _forward_decode(self, clips: torch.Tensor,
                        flow_clips: Optional[torch.Tensor] = None
                        ) -> DecodedWindows:
        with torch.inference_mode():
            return self._decode(fused_forward(
                (self.model, self.flow_model),
                [clips] if flow_clips is None else [clips, flow_clips]))

    def forward_decode(self, clips: torch.Tensor,
                       flow_clips: Optional[torch.Tensor] = None
                       ) -> DecodedWindows:
        """(W, C, T, H, W) clips (and the flow stream's) -> decoded
        windows, on the device; on a mesh split over its ranks."""
        return self._sharded(self._forward_decode, [clips, flow_clips])

    def windows_decode(self, bufs: Sequence[torch.Tensor],
                       offsets: torch.Tensor,
                       frames_valid: Sequence[Union[int, torch.Tensor]],
                       flush: Optional[int] = None) -> DecodedWindows:
        """Windows at `offsets` (W,) gathered from each stream's staged
        uint8 buffer (`device_windows`, with that stream's frames-valid:
        a scalar or (W,)) through forward + decode; on a mesh each rank
        gathers only its share of the windows. Span `infer.forward` (its
        request id `flush`), counter `infer.rows` (the W rows)."""
        def decode(offs, *fvs):
            return self._forward_decode(*[
                device_windows(buf, offs, fv, self.clip_length)
                for buf, fv in zip(bufs, fvs)])
        with profiling.span('infer.forward', flush):
            profiling.count('infer.rows', offsets.shape[0])
            return self._sharded(decode, [offsets, *frames_valid])

    @property
    def span(self) -> int:
        """Frames of a shared-backbone span: k windows at the stride,
        + 8 for the tail offset snapped up to a multiple of 8."""
        return self.stride * (self.shared_group - 1) + self.clip_length + 8

    def span_decode(self, bufs: Sequence[torch.Tensor], bases: torch.Tensor,
                    local: torch.Tensor,
                    frames_valid: Union[int, torch.Tensor]
                    ) -> DecodedWindows:
        """Shared-backbone forward + decode of b spans: each span is
        gathered from the staged uint8 buffer(s) (one per stream, with
        the same geometry) at `bases` (b,), frames >= frames_valid (a
        scalar, or (b,) for spans of several videos) zeroed, through the
        backbone once; each window's features are sliced from its span at
        `local` (b, k) and run through the pyramid and heads. Returns the
        decode of the b * k windows, span-major; on a mesh each rank runs
        its share of the spans."""
        def decode(bases, local, frames_valid):
            def forward(model, spans):
                return model.detect_from_features(window_features(
                    model.backbone_features(spans), local,
                    self.clip_length))
            with torch.inference_mode():
                return self._decode(fused_forward(
                    (self.model, self.flow_model),
                    [device_windows(buf, bases, frames_valid, self.span)
                     for buf in bufs], forward))
        return self._sharded(decode, [bases, local, frames_valid],
                             per_row=local.shape[1])

    def _fusion(self, flow_data) -> bool:
        """Whether a video runs fused; a fusion pipeline needs its flow
        frames and a single-stream one takes none."""
        if (flow_data is None) != (self.flow_model is None):
            raise ValueError('flow frames are needed exactly when the '
                             'pipeline has a flow model')
        return flow_data is not None

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == 'cuda':
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    # ---------------------------------------------------------- per video

    def decode_video(self, data: np.ndarray, sample_count: int,
                     max_batch: int = 32,
                     flow_data: Optional[np.ndarray] = None):
        """Windows of one (T, H, W, C) uint8 video (and its flow frames)
        through forward + decode. Returns (DecodedWindows over all
        windows, offsets)."""
        fusion = self._fusion(flow_data)
        _require_u8(data)
        data = transforms.center_crop(data, self.crop_size)
        streams = [data]
        if fusion:
            _require_u8(flow_data, 'flow frames')
            streams.append(transforms.center_crop(flow_data,
                                                  self.crop_size))
        offsets = window_offsets(sample_count, self.clip_length,
                                 self.stride)
        self._check_batch(max_batch)
        chunks = range(0, len(offsets), max_batch)
        if self.device_ingest:
            offs = self._to_device(np.asarray(offsets, np.int64))
            # each stream's buffer holds every window slice, also when
            # the npy is shorter than sample_count; each stream keeps its
            # own frames-valid (a flow npy may be a frame shorter)
            staged = [(stage_frames(s, pad_to=max(offsets[-1]
                                                  + self.clip_length,
                                                  s.shape[0]),
                                    device=self.device),
                       min(s.shape[0], sample_count)) for s in streams]
            bufs = [buf for buf, _ in staged]
            valids = [valid for _, valid in staged]
            parts = [self.windows_decode(bufs, offs[i:i + max_batch],
                                         valids) for i in chunks]
            profiling.count('infer.windows', len(offsets))
        else:
            stacked = [stack_windows(s, offsets, self.clip_length)
                       for s in streams]
            parts = [self.forward_decode(*[self._to_device(
                w[i:i + max_batch]).permute(0, 4, 1, 2, 3).contiguous()
                for w in stacked]) for i in chunks]
        return _cat_decoded(parts), offsets

    def run_video(self, data: np.ndarray, sample_count: int,
                  sample_fps: float, flow_data: Optional[np.ndarray] = None,
                  max_batch: int = 32) -> List[Dict[str, Any]]:
        """data: (T, H, W, C) uint8 full video (flow_data its (T', H, W, 2)
        flow frames for fusion). Returns the per-video proposal list
        (label idx, score, segment seconds, uncertainty, actionness).
        With shared_backbone the windows run in spans
        (`_run_video_shared`)."""
        if self.shared_backbone:
            return self._run_video_shared(data, sample_count, sample_fps,
                                          flow_data)
        dec, offsets = self.decode_video(data, sample_count, max_batch,
                                         flow_data)
        return self._post(dec, offsets, sample_fps)

    def _shared_streams(self, data: np.ndarray,
                        flow_data: Optional[np.ndarray], name: str = ''
                        ) -> List[np.ndarray]:
        """The cropped uint8 frames of a video's streams for the shared
        path; the flow stream is cut to the RGB length and shares its
        frames-valid, as in the JAX package."""
        fusion = self._fusion(flow_data)
        _require_u8(data, f'frames{name}')
        streams = [transforms.center_crop(data, self.crop_size)]
        if fusion:
            _require_u8(flow_data, f'flow frames{name}')
            streams.append(transforms.center_crop(
                flow_data, self.crop_size)[:len(data)])
        return streams

    def _run_video_shared(self, data: np.ndarray, sample_count: int,
                          sample_fps: float,
                          flow_data: Optional[np.ndarray] = None
                          ) -> List[Dict[str, Any]]:
        """run_video with a shared backbone: k consecutive windows share
        one span; up to `shared_max_groups` spans per forward
        (`opental_tpu/infer/pipeline.py:1116`)."""
        streams = self._shared_streams(data, flow_data)
        offsets = snapped_offsets(sample_count, self.clip_length,
                                  self.stride)
        bases, local, _ = span_plan(offsets, self.shared_group)
        t = len(data)
        bufs = [stage_frames(s, pad_to=max(t, int(bases[-1]) + self.span),
                             device=self.device) for s in streams]
        frames_valid = min(t, sample_count)
        bases_d, local_d = self._to_device(bases), self._to_device(local)
        n, step = len(offsets), self.shared_max_groups
        parts = [self.span_decode(bufs, bases_d[i:i + step],
                                  local_d[i:i + step], frames_valid)
                 for i in range(0, len(bases), step)]
        return self._post(_slice_decoded(_cat_decoded(parts), 0, n),
                          offsets, sample_fps)

    def _post(self, dec: DecodedWindows, offsets: Sequence[int],
              sample_fps: float, name: Optional[str] = None
              ) -> List[Dict[str, Any]]:
        """One video's proposals from its decoded windows. Span
        `post.video` (its request id the video's name)."""
        with profiling.span('post.video', name):
            if self.device_post:
                return self.post_process_on_device(dec, offsets, sample_fps)
            off = np.asarray(offsets, np.float32)[:, None, None]
            with profiling.span('post.fetch'):
                seconds = (dec.segments.float().cpu().numpy() + off) \
                    / sample_fps
                conf, unct, act = [
                    None if a is None else a.float().cpu().numpy()
                    for a in (dec.scores, dec.uncertainty, dec.actionness)]
            return self.post_process(seconds, conf, unct, act)

    def _finish_packed(self, vid: Dict[str, Any],
                       results: Dict[str, List[Dict[str, Any]]]) -> None:
        """Post-process one finished video from its collected decode
        rows (still on the device), as run_video does."""
        results[vid['name']] = self._post(_cat_decoded(vid['got']),
                                          vid['offsets'], vid['fps'],
                                          vid['name'])

    # -------------------------------------------------------- per dataset

    def run_videos(self, videos, max_batch: int = 128,
                   frames_capacity: int = 32768
                   ) -> Dict[str, List[Dict[str, Any]]]:
        """Packed cross-video inference: windows of consecutive videos
        fill forwards of `max_batch` windows (the tail batch zero-pads),
        so short videos do not underfill the device.

        videos: iterable of (name, data, sample_count, sample_fps), with
        the flow frames as a fifth item for fusion, consumed lazily.
        Returns {name: proposals}. With shared_backbone the spans pack
        across videos (`run_videos_shared`); with device ingest the
        videos' raw frames pack into device frame buffers
        (`run_videos_ingest`); otherwise uint8 windows are cut and packed
        on the host, as below.
        """
        if self.shared_backbone:
            return self.run_videos_shared(videos,
                                          frames_capacity=frames_capacity)
        if self.device_ingest:
            return self.run_videos_ingest(videos, max_batch=max_batch,
                                          frames_capacity=frames_capacity)
        self._check_batch(max_batch)
        fusion = self.flow_model is not None
        pending: List[Dict[str, Any]] = []   # FIFO of open videos
        queues: List[List[np.ndarray]] = [[] for _ in range(
            4 if fusion else 2)]             # windows, valids (, flow's)
        buffered = 0
        results: Dict[str, List[Dict[str, Any]]] = {}

        def cat_pad(arrs, pad_to):
            batch = np.concatenate(arrs) if len(arrs) > 1 else arrs[0]
            if pad_to is not None and batch.shape[0] < pad_to:
                pad = np.zeros((pad_to - batch.shape[0],) + batch.shape[1:],
                               batch.dtype)
                batch = np.concatenate([batch, pad])
            return batch

        def split_queue(arrs, cap):
            """Split an exactly-`cap` window batch off the queue front;
            depends only on leading dims, so parallel queues split
            alike."""
            head, rest, acc = [], [], 0
            for a in arrs:
                if acc + a.shape[0] <= cap:
                    head.append(a)
                    acc += a.shape[0]
                elif acc < cap:
                    head.append(a[:cap - acc])
                    rest.append(a[cap - acc:])
                    acc = cap
                else:
                    rest.append(a)
            return head, rest

        def flush(heads, n_rows, pad_to=None):
            """Forward one batch (pad rows carry valid 0: all-zero
            frames) and hand its rows to the open videos in order."""
            arrs = [self._to_device(cat_pad(q, pad_to)) for q in heads]
            clips = [ingest_windows(arrs[j], arrs[j + 1])
                     for j in range(0, len(arrs), 2)]
            _route_rows(pending, self.forward_decode(*clips), n_rows)
            while pending and pending[0]['need'] == 0:
                self._finish_packed(pending.pop(0), results)

        for item in videos:
            name, data, sample_count, sample_fps = item[:4]
            flow_data = item[4] if fusion else None
            offsets = window_offsets(sample_count, self.clip_length,
                                     self.stride)
            streams = [data] + ([flow_data] if fusion else [])
            for j, s in enumerate(streams):
                _require_u8(s, f'{"flow " if j else ""}frames ({name})')
                clips, valid = stack_windows_u8(
                    transforms.center_crop(s, self.crop_size), offsets,
                    self.clip_length)
                queues[2 * j].append(clips)
                queues[2 * j + 1].append(valid)
            buffered += len(offsets)
            pending.append(_new_video(name, offsets, sample_fps))
            while buffered >= max_batch:
                split = [split_queue(q, max_batch) for q in queues]
                flush([h for h, _ in split], max_batch)
                queues = [r for _, r in split]
                buffered -= max_batch
        if buffered:
            flush(queues, buffered, pad_to=max_batch)
        assert not pending, 'scheduler left unfinished videos'
        return results

    def run_videos_ingest(self, videos, max_batch: int = 128,
                          frames_capacity: int = 16384
                          ) -> Dict[str, List[Dict[str, Any]]]:
        """Packed frame-staged inference: the raw uint8 frames of
        consecutive videos fill one device frame buffer per flush;
        windows are gathered and normalized on the device
        (`device_windows`, per-window frames-valid) and batched into full
        `max_batch` forwards across video boundaries.

        Each frame crosses the link once. A flush's buffer holds `cap =
        k * frames_capacity` frames (k = 1 unless one video alone is
        longer); each video takes a region of max(its last window's end,
        its frame count) frames, so windows never cross into the next
        video except through their tail, which frames-valid zeroes. The
        window list pads to whole `max_batch` forwards with valid-0 rows
        (all-zero inputs). The next flush is assembled in pinned host
        memory and copied (non-blocking, on a side stream) on a
        background thread while this flush's forwards run; the compute
        stream waits on the copy's event, and each staged tensor is
        recorded on the compute stream, so its memory is not reused
        before the forwards that read it have run. Decoded rows go back
        to their videos in order. For fusion, twin RGB / flow buffers
        share one region layout and one offsets array; each stream keeps
        its own frames-valid (a flow npy may be a frame shorter).

        Post-processing runs one flush behind: a flush's videos are
        post-processed, in order, once the next flush's forwards are
        under way (the last flush's after the loop), so the host formats
        one flush's proposals while the card runs the next one's
        forwards. On a card a forward is ~3,500 launches and the
        CUDA launch queue holds ~1,000, so the thread that queues a
        forward is held until the card nears its end: each flush's
        forwards are queued on a launcher thread of their own (made once
        per call; PyTorch's operators release the GIL while a launch
        waits), while the calling thread post-processes the flush
        before. The posts run on a high-priority stream made once per
        call, which first waits on an event recorded on the compute
        stream after the flush's last forward and decode: the posts' own
        syncs (the offsets' copy, the kept blocks' fetch) wait for that
        stream alone, never for the later forwards, and its short
        kernels do not queue behind theirs. A video's decoded rows stay
        referenced until its post has returned, past the fetch that
        waits for every read of them. Off the card the forwards run on
        the calling thread, then the flush before is post-processed,
        with no streams. Counter `post.behind`: per video
        post-processed, its real windows where a later flush's forwards
        were under way, else 0.

        videos: iterable of (name, data, sample_count, sample_fps), with
        the flow frames fifth for fusion, consumed lazily. Returns
        {name: proposals}, in the order the videos came.
        """
        self._check_batch(max_batch)
        fusion = self.flow_model is not None
        clip, stride = self.clip_length, self.stride
        cuda = self.device.type == 'cuda'
        results: Dict[str, List[Dict[str, Any]]] = {}

        def host_buffer(shape) -> torch.Tensor:
            return torch.empty(shape, dtype=torch.uint8, pin_memory=cuda)

        def plans():
            staged: List[Dict[str, Any]] = []
            cursor = flush = 0

            def close():
                nonlocal staged, cursor, flush
                with profiling.span('ingest.plan', flush,
                                    videos=len(staged), frames=cursor):
                    plan = assemble()
                staged, cursor, flush = [], 0, flush + 1
                return plan

            def assemble():
                plan = {'cap': -(-max(cursor, 1) // frames_capacity)
                        * frames_capacity, 'vids': staged, 'flush': flush}
                offs, fvs = [], [[] for _ in staged[0]['streams']]
                for j, s in enumerate(staged[0]['streams']):
                    # filled through a numpy view of the (pinned) buffer
                    buf = host_buffer((cursor,) + s.shape[1:])
                    view = buf.numpy()
                    for v in staged:
                        frames = v['streams'][j]
                        view[v['start']:v['start'] + len(frames)] = frames
                        view[v['start'] + len(frames):
                             v['start'] + v['region']] = 0
                        fvs[j].append(np.full(
                            (len(v['offsets']),),
                            v['start'] + min(len(frames), v['count']),
                            np.int64))
                    plan[f'host{j}'] = buf
                for v in staged:
                    offs.append(v['start'] + np.asarray(v['offsets'],
                                                        np.int64))
                    del v['streams']        # free the per-video frames
                n = sum(len(o) for o in offs)
                pad = np.zeros((_bucket(n, max_batch) - n,), np.int64)
                plan['n'] = n
                plan['offs'] = np.concatenate(offs + [pad])
                for j, fv in enumerate(fvs):
                    plan[f'fv{j}'] = np.concatenate(fv + [pad])
                return plan

            for item in videos:
                name, data, sample_count, sample_fps = item[:4]
                streams = [data] + ([item[4]] if fusion else [])
                for j, s in enumerate(streams):
                    _require_u8(s, f'{"flow " if j else ""}frames '
                                   f'({name})')
                streams = [transforms.center_crop(s, self.crop_size)
                           for s in streams]
                offsets = window_offsets(sample_count, clip, stride)
                # the region holds every window slice even where the npy
                # is shorter than sample_count; fusion's streams share it
                region = max([offsets[-1] + clip]
                             + [len(s) for s in streams])
                if staged and cursor + region > frames_capacity:
                    yield close()
                staged.append(_new_video(name, offsets, sample_fps,
                                         streams=streams, start=cursor,
                                         region=region,
                                         count=sample_count))
                cursor += region
            if staged:
                yield close()

        side = torch.cuda.Stream(self.device) if cuda else None
        compute = torch.cuda.current_stream(self.device) if cuda else None
        post_stream = (torch.cuda.Stream(self.device, priority=-1)
                       if cuda else None)

        def on(stream):
            return (torch.cuda.stream(stream) if cuda
                    else contextlib.nullcontext())
        n_streams = 2 if fusion else 1
        staged_keys = ['offs'] + [f'{p}{j}' for j in range(n_streams)
                                  for p in ('buf', 'fv')]

        def stage(plan):
            """Host plan -> device tensors, on the side stream (runs on
            the prefetch thread)."""
            with profiling.span('ingest.stage', plan['flush']), on(side):
                for j in range(n_streams):
                    plan[f'buf{j}'] = stage_frames(
                        plan.pop(f'host{j}'), pad_to=plan['cap'],
                        device=self.device)
                for key in ['offs'] + [f'fv{j}' for j in range(n_streams)]:
                    plan[key] = self._to_device(plan[key])
                if cuda:
                    plan['ready'] = torch.cuda.Event()
                    plan['ready'].record(side)
            return plan

        def forwards(plan):
            """Queue a flush's forwards and decodes on the compute stream;
            returns its videos and an event recorded after them."""
            with on(compute):
                if cuda:
                    compute.wait_event(plan['ready'])
                    for key in staged_keys:
                        plan[key].record_stream(compute)
                vids, vi = plan['vids'], 0
                for i in range(0, plan['offs'].shape[0], max_batch):
                    dec = self.windows_decode(
                        [plan[f'buf{j}'] for j in range(n_streams)],
                        plan['offs'][i:i + max_batch],
                        [plan[f'fv{j}'][i:i + max_batch]
                         for j in range(n_streams)], plan['flush'])
                    real = max(0, min(max_batch, plan['n'] - i))
                    profiling.count('infer.windows', real)
                    vi = _route_rows(vids, dec, real, vi)
                done = None
                if cuda:
                    done = torch.cuda.Event()
                    done.record(compute)
            return vids, done

        def post(vids, done, hidden: bool):
            """Post-process a flush's videos in order, on the post stream
            once the compute stream has passed `done`; `hidden`: while a
            later flush's forwards are under way."""
            with on(post_stream):
                if cuda:
                    post_stream.wait_event(done)
                for vid in vids:
                    self._finish_packed(vid, results)
                    profiling.count('post.behind',
                                    len(vid['offsets']) if hidden else 0)

        behind = None                   # the flush before: (videos, event)
        with contextlib.ExitStack() as stack:
            staged_plans = stack.enter_context(contextlib.closing(
                prefetch_items(plans(), transform=stage, depth=2,
                               wait='ingest.wait')))
            launcher = stack.enter_context(ThreadPoolExecutor(
                1, thread_name_prefix='opental-torch-launch')) \
                if cuda else None
            for plan in staged_plans:
                flush = (forwards(plan) if launcher is None
                         else launcher.submit(forwards, plan))
                del plan
                if behind is not None:
                    post(*behind, hidden=True)
                behind = flush if launcher is None else flush.result()
        if behind is not None:
            post(*behind, hidden=False)
        return results

    def run_videos_shared(self, videos, frames_capacity: int = 32768
                          ) -> Dict[str, List[Dict[str, Any]]]:
        """Packed shared-backbone inference
        (`opental_tpu/infer/pipeline.py:873-1016`): the spans of
        consecutive videos fill forwards of `shared_max_groups` spans over
        one staged uint8 buffer per flush of up to `frames_capacity`
        frames (more for one longer video). Each video starts at a
        multiple of 8 and takes a region of max(its last span's end, its
        frame count) frames, so every span lies in the buffer; each span
        carries its own frames-valid (its video's end), so a span reading
        into the next video's region zeroes those frames, as per-video
        zero padding. Decoded rows stay on the device until their video
        is post-processed after its flush.

        videos: iterable of (name, data, sample_count, sample_fps), with
        the flow frames fifth for fusion, consumed lazily. Returns
        {name: proposals}.
        """
        fusion = self.flow_model is not None
        k, span = self.shared_group, self.span
        results: Dict[str, List[Dict[str, Any]]] = {}
        staged: List[Dict[str, Any]] = []
        cursor = 0

        def flush():
            bufs = []
            for j in range(len(staged[0]['streams'])):
                shape = staged[0]['streams'][j].shape[1:]
                host = np.zeros((cursor,) + shape, np.uint8)
                for v in staged:
                    frames = v['streams'][j]
                    host[v['start']:v['start'] + len(frames)] = frames
                bufs.append(stage_frames(host, device=self.device))
            spans = [(v, c) for v in staged for c in v['counts']]
            bases = self._to_device(np.concatenate(
                [v['bases'] for v in staged]))
            local = self._to_device(np.concatenate(
                [v['local'] for v in staged]))
            fv = self._to_device(np.concatenate([v['fv'] for v in staged]))
            step = self.shared_max_groups
            for i in range(0, len(spans), step):
                dec = self.span_decode(bufs, bases[i:i + step],
                                       local[i:i + step], fv[i:i + step])
                for j, (vid, count) in enumerate(spans[i:i + step]):
                    vid['got'].append(_slice_decoded(dec, j * k,
                                                     j * k + count))
            for v in staged:
                self._finish_packed(v, results)

        for item in videos:
            name, data, sample_count, sample_fps = item[:4]
            streams = self._shared_streams(
                data, item[4] if fusion else None, f' ({name})')
            offsets = snapped_offsets(sample_count, self.clip_length,
                                      self.stride)
            bases, local, counts = span_plan(offsets, k)
            t = len(data)
            need = max(int(bases[-1]) + span, t)
            start = -(-cursor // 8) * 8
            if staged and start + need > frames_capacity:
                flush()
                staged, start = [], 0
            staged.append(_new_video(
                name, offsets, sample_fps, streams=streams, start=start,
                bases=start + bases, local=local, counts=counts,
                fv=np.full((len(bases),), start + min(t, sample_count),
                           np.int64)))
            cursor = start + need
        if staged:
            flush()
        return results

    # ---------------------------------------------------- post-processing

    def post_process_on_device(self, dec: DecodedWindows,
                               offsets: Sequence[int], sample_fps: float
                               ) -> List[Dict[str, Any]]:
        """Seconds shift + per-class top-k preselect + batched soft-NMS of
        every class at once, on the device; the host formats kept rows.
        Spans `post.preselect`, `post.soft_nms`, `post.fetch` (the kept
        blocks' copy to the host) and `post.format`."""
        with profiling.span('post.preselect'):
            cls_cols, cands, valid = self._preselect(dec, offsets,
                                                     sample_fps)
        with profiling.span('post.soft_nms'):
            blocks, _ = soft_nms_device(cands, sigma=self.nms_sigma,
                                        top_k=self.top_k, valid=valid)
        with profiling.span('post.fetch'):
            blocks = blocks.cpu().numpy()                      # (C, k, D+1)
        with profiling.span('post.format'):
            return self._format(blocks, cls_cols)

    def _preselect(self, dec: DecodedWindows, offsets: Sequence[int],
                   sample_fps: float):
        """(the class columns, each class's top-k candidates (C, k, D)
        with seconds, score and extras, their validity (C, k))."""
        k = self.num_classes
        cls_cols = list(range(k)) if self.os_head else list(range(1, k))
        segments, scores = dec.segments, dec.scores
        w, p = segments.shape[:2]
        off = torch.as_tensor(np.asarray(offsets, np.float32),
                              device=segments.device)
        seconds = ((segments.float() + off[:, None, None])
                   / float(sample_fps)).reshape(-1, 2)
        flat = scores.reshape(-1, scores.shape[-1])
        gate = torch.ones(w * p, dtype=torch.bool, device=flat.device)
        extras = []
        if self.use_edl:
            extras.append(dec.uncertainty.reshape(-1))
        if self.os_head:
            a = dec.actionness.reshape(-1)
            gate = gate & (a > 0.5)
            extras.append(a)
        k_eff = min(self.n_candidates, flat.shape[0])
        stacked = flat[:, cls_cols].t()                       # (C, N)
        sc = torch.where((stacked > self.conf_thresh) & gate[None],
                         stacked, 0.0)
        # a stable sort puts equal scores in index order, as lax.top_k
        top_sc, idx = torch.sort(sc, dim=1, descending=True, stable=True)
        top_sc, idx = top_sc[:, :k_eff], idx[:, :k_eff]
        cols = [seconds[idx], top_sc[..., None].float()]
        cols += [e[idx][..., None].float() for e in extras]
        return cls_cols, torch.cat(cols, dim=-1), top_sc > 0

    def _format(self, blocks: np.ndarray, cls_cols: Sequence[int]
                ) -> List[Dict[str, Any]]:
        """The kept rows of each class's soft-NMS block as proposals."""
        proposals: List[Dict[str, Any]] = []
        for ci, cl in enumerate(cls_cols):
            kept = blocks[ci]
            kept = kept[(kept[:, -1] > 0) & (kept[:, 2] > 0)]
            cl_idx = cl + 1 if self.os_head else cl
            for row in kept:
                proposals.append({
                    'cls': int(cl_idx),
                    'score': float(row[2]),
                    'segment': [float(row[0]), float(row[1])],
                    'uncertainty': float(row[3]) if self.use_edl else 0.0,
                    'actionness': (float(row[-2]) if self.os_head
                                   else 0.0),
                })
        return proposals

    def _soft_nms(self, block: np.ndarray) -> np.ndarray:
        """Greedy gaussian-decay suppression of one class's candidates:
        host numpy, or with device_nms the block padded to a power of two
        (at least 64 rows) through `soft_nms_device`; the same rows are
        kept either way."""
        if not self.device_nms:
            kept, _ = soft_nms_numpy(block, sigma=self.nms_sigma,
                                     top_k=self.top_k)
            return kept
        n, d = block.shape
        n_pad = max(64, 1 << (n - 1).bit_length())
        padded = torch.zeros((n_pad, d), dtype=torch.float32,
                             device=self.device)
        padded[:n] = torch.from_numpy(np.ascontiguousarray(
            block, np.float32)).to(self.device)
        valid = torch.arange(n_pad, device=self.device) < n
        out, _ = soft_nms_device(padded, sigma=self.nms_sigma,
                                 top_k=self.top_k, valid=valid)
        out = out.cpu().numpy()
        return out[out[:, -1] > 0][:, :-1]

    def post_process(self, seconds: np.ndarray, conf: np.ndarray,
                     unct: Optional[np.ndarray], act: Optional[np.ndarray]
                     ) -> List[Dict[str, Any]]:
        """Host path: per-class filter + soft-NMS + top-k
        (test.py:143-200). seconds (W, P, 2), conf (W, P, K)."""
        w, p, k = conf.shape
        seconds = seconds.reshape(-1, 2)
        conf = conf.reshape(-1, k)
        flat_unct = unct.reshape(-1) if unct is not None else None
        flat_act = act.reshape(-1) if act is not None else None
        cls_range = range(0, k) if self.os_head else range(1, k)
        proposals: List[Dict[str, Any]] = []
        for cl in cls_range:
            mask = conf[:, cl] > self.conf_thresh
            if self.os_head:
                mask &= flat_act > 0.5
            if not mask.any():
                continue
            cols = [seconds[mask], conf[mask, cl][:, None]]
            if self.use_edl:
                cols.append(flat_unct[mask][:, None])
            if self.os_head:
                cols.append(flat_act[mask][:, None])
            with profiling.span('post.soft_nms'):
                kept = self._soft_nms(np.concatenate(cols, axis=1))
            cl_idx = cl + 1 if self.os_head else cl
            for row in kept:
                if row[2] <= 0:
                    continue
                proposals.append({
                    'cls': int(cl_idx),
                    'score': float(row[2]),
                    'segment': [float(row[0]), float(row[1])],
                    'uncertainty': float(row[3]) if self.use_edl else 0.0,
                    'actionness': (float(row[-1]) if self.os_head else 0.0),
                })
        return proposals


def packed_frames(te: dict) -> int:
    """frames_capacity of the packed modes, as the JAX CLI picks it
    (`opental_tpu/tools/test.py:29-36`): `testing.packed_frames`, else
    16384 frames per device-ingest flush (453 MB of 96 x 96 RGB) and
    32768 for the host-staged windows."""
    return te.get('packed_frames',
                  16384 if te.get('device_ingest', True) else 32768)


def infer_videos(pipe: InferencePipeline, te: dict, video_infos: dict,
                 names: List[str], npy_path: str, flow_path: str
                 ) -> Dict[str, List[dict]]:
    """Proposals of each named video: packed across videos
    (`testing.packed`, default true; `testing.packed_batch` windows per
    forward, `packed_frames(te)` frames per flush) or one video at a
    time. The next video loads from disk on a thread meanwhile."""
    fusion = pipe.flow_model is not None

    def load(name):
        info = video_infos[name]
        item = (name, np.load(os.path.join(npy_path, name + '.npy')),
                info['sample_count'], info['sample_fps'])
        if fusion:
            item += (np.load(os.path.join(flow_path, name + '.npy')),)
        return item

    with contextlib.closing(prefetch_items(names, load,
                                           wait='loader.wait')) as videos:
        if te.get('packed', True):
            return pipe.run_videos(videos,
                                   max_batch=te.get('packed_batch', 128),
                                   frames_capacity=packed_frames(te))
        return {name: pipe.run_video(data, sample_count, fps,
                                     flow_data=flow[0] if flow else None)
                for name, data, sample_count, fps, *flow in videos}


def proposals_to_json(result_dict: Dict[str, List[Dict[str, Any]]],
                      idx_to_class: Dict[int, str], output_path: str,
                      json_name: str, version: str = 'THUMOS14',
                      external_data: Optional[dict] = None) -> str:
    """Write the detection JSON (reference schema, test.py:254-256)."""
    results = {}
    for video, props in result_dict.items():
        results[video] = [{
            'label': idx_to_class[p['cls']],
            'score': p['score'],
            'segment': p['segment'],
            'uncertainty': p['uncertainty'],
            'actionness': p['actionness'],
        } for p in props]
    payload = {'version': version, 'results': results,
               'external_data': external_data or {}}
    os.makedirs(output_path, exist_ok=True)
    path = os.path.join(output_path, json_name)
    with open(path, 'w') as f:
        json.dump(payload, f)
    return path
