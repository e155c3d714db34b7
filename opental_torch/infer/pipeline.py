"""Window-batched video inference pipeline (PyTorch).

Counterpart of `opental_tpu/infer/pipeline.py:28-489, 1227-1406`;
reference AFSD/thumos14/test.py:203-256. A video's raw uint8 frames go
to the device once; windows are gathered and normalized there
(`device_windows`), run through the model and decoded in batches, and
post-processing runs either fused on the device (per-class top-k
preselect + batched soft-NMS, the default) or on the host (numpy
soft-NMS per class, the reference's semantics). Output JSON matches
test.py:254-256.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from opental_torch import resolve_device
from opental_torch.data import transforms
from opental_torch.infer.decode import DecodedWindows, decode_windows
from opental_torch.ops.nms import soft_nms_device, soft_nms_numpy


def window_offsets(sample_count: int, clip_length: int,
                   stride: int) -> List[int]:
    """Sliding-window offsets incl. the tail window (test.py:48-56)."""
    if sample_count < clip_length:
        return [0]
    offsets = list(range(0, sample_count - clip_length + 1, stride))
    if (sample_count - clip_length) % stride:
        offsets.append(sample_count - clip_length)
    return offsets


def device_windows(video_u8: torch.Tensor, offsets: torch.Tensor,
                   frames_valid: Union[int, torch.Tensor],
                   clip_length: int) -> torch.Tensor:
    """Window gather + normalization on the video's device.

    video_u8: (Tp, H, W, C) uint8 holding every window's frames; offsets:
    (Wc,) int64; frames >= frames_valid (a scalar or (Wc,)) are zero after
    normalization, as the reference pads (test.py:67-76). Returns
    (Wc, C, clip, H, W) float32 in [-1, 1], the model's layout.
    """
    steps = torch.arange(clip_length, device=video_u8.device)
    idx = offsets[:, None] + steps                          # (Wc, clip)
    win = video_u8[idx].permute(0, 4, 1, 2, 3)              # (Wc, C, clip, H, W)
    x = (win.float() / 255.0) * 2.0 - 1.0
    valid = torch.as_tensor(frames_valid, device=video_u8.device)
    keep = idx < valid.reshape(-1, 1)
    return torch.where(keep[:, None, :, None, None], x, 0.0).contiguous()


class InferencePipeline:
    """Forward + decode over window batches for one model.

    The model (a port BDNet with its weights) moves to `device`, the card
    unless the caller asks for the CPU. device_post=True (default) runs
    the fused device post-processing; False the host numpy path.
    n_candidates bounds the per-class device preselect (2048, the THUMOS
    CLI's default).
    """

    def __init__(self, model: torch.nn.Module, clip_length: int = 256,
                 stride: int = 128, crop_size: int = 96,
                 conf_thresh: float = 0.01, top_k: int = 5000,
                 nms_sigma: float = 0.5, use_edl: bool = False,
                 os_head: bool = False, evidence: str = 'exp', device_post: bool = True,
                 n_candidates: int = 2048,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.clip_length = clip_length
        self.stride = stride
        self.crop_size = crop_size
        self.conf_thresh = conf_thresh
        self.top_k = top_k
        self.nms_sigma = nms_sigma
        self.use_edl = use_edl
        self.os_head = os_head
        self.evidence = evidence
        self.num_classes = model.head_classes
        self.device_post = device_post
        self.n_candidates = n_candidates

    def forward_decode(self, clips: torch.Tensor) -> DecodedWindows:
        """(W, C, T, H, W) clips -> decoded windows, on the device."""
        with torch.inference_mode():
            out = self.model(clips)
            return decode_windows(
                out, self.clip_length, use_edl=self.use_edl,
                os_head=self.os_head,
                score_func='dirichlet' if self.use_edl else 'softmax',
                evidence=self.evidence)

    def decode_video(self, data: np.ndarray, sample_count: int,
                     max_batch: int = 32):
        """Windows of one (T, H, W, C) uint8 video through forward +
        decode. Returns (DecodedWindows over all windows, offsets)."""
        if data.dtype != np.uint8:
            raise TypeError(f'video frames must be uint8, got {data.dtype}')
        data = np.ascontiguousarray(
            transforms.center_crop(data, self.crop_size))
        offsets = window_offsets(sample_count, self.clip_length,
                                 self.stride)
        t = data.shape[0]
        # the buffer holds every window slice, also when the npy is
        # shorter than sample_count; frames past the video are zeros
        need = max(max(offsets) + self.clip_length, t)
        video = torch.zeros((need,) + data.shape[1:], dtype=torch.uint8,
                            device=self.device)
        video[:t] = torch.from_numpy(data).to(self.device)
        valid = min(t, sample_count)
        offs = torch.as_tensor(offsets, dtype=torch.int64,
                               device=self.device)
        parts = [self.forward_decode(device_windows(
            video, offs[i:i + max_batch], valid, self.clip_length))
            for i in range(0, len(offsets), max_batch)]

        def cat(field):
            xs = [getattr(p, field) for p in parts]
            return None if xs[0] is None else torch.cat(xs)

        return DecodedWindows(*(cat(f) for f in DecodedWindows._fields)), \
            offsets

    def run_video(self, data: np.ndarray, sample_count: int,
                  sample_fps: float, max_batch: int = 32
                  ) -> List[Dict[str, Any]]:
        """data: (T, H, W, C) uint8 full video. Returns the per-video
        proposal list (label idx, score, segment seconds, uncertainty,
        actionness)."""
        dec, offsets = self.decode_video(data, sample_count, max_batch)
        if self.device_post:
            return self.post_process_on_device(dec, offsets, sample_fps)
        off = np.asarray(offsets, np.float32)[:, None, None]
        seconds = (dec.segments.float().cpu().numpy() + off) / sample_fps

        def host(a):
            return None if a is None else a.float().cpu().numpy()

        return self.post_process(seconds, host(dec.scores),
                                 host(dec.uncertainty),
                                 host(dec.actionness))

    def run_videos(self, videos, max_batch: int = 128,
                   frames_capacity: int = 32768
                   ) -> Dict[str, List[Dict[str, Any]]]:
        """videos: iterable of (name, data, sample_count, sample_fps),
        consumed lazily. Returns {name: proposals}. Each video runs
        through run_video in batches of at most `max_batch` windows;
        cross-video packing (frames_capacity) is not ported yet."""
        results: Dict[str, List[Dict[str, Any]]] = {}
        for item in videos:
            name, data, sample_count, sample_fps = item[:4]
            results[name] = self.run_video(data, sample_count, sample_fps,
                                           max_batch=max_batch)
        return results

    def post_process_on_device(self, dec: DecodedWindows,
                               offsets: Sequence[int], sample_fps: float
                               ) -> List[Dict[str, Any]]:
        """Seconds shift + per-class top-k preselect + batched soft-NMS of
        every class at once, on the device; the host formats kept rows."""
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
        blocks, _ = soft_nms_device(torch.cat(cols, dim=-1),
                                    sigma=self.nms_sigma, top_k=self.top_k,
                                    valid=top_sc > 0)
        blocks = blocks.cpu().numpy()                          # (C, k, D+1)
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

    def post_process(self, seconds: np.ndarray, conf: np.ndarray,
                     unct: Optional[np.ndarray], act: Optional[np.ndarray]
                     ) -> List[Dict[str, Any]]:
        """Host path: per-class filter + numpy soft-NMS + top-k
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
            kept, _ = soft_nms_numpy(np.concatenate(cols, axis=1),
                                     sigma=self.nms_sigma, top_k=self.top_k)
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
