"""THUMOS14 annotation parsing, clip splitting, SSL augmentation and the
training dataset.

Counterpart of `opental_tpu/data/thumos.py` (reference
AFSD/common/thumos_dataset.py): host-side numpy that emits fixed-shape,
channels-last samples with padded GT tensors.
"""

from __future__ import annotations

import csv
import math
import os
import random
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from opental_torch.data import transforms
from opental_torch.utils import profiling

MAX_GT = 24          # padded GT slots per clip (max observed ~15 on THUMOS)
SSL_SEGMENTS = 3


def get_class_index_map(class_info_path: str
                        ) -> Tuple[Dict[int, int], Dict[int, str]]:
    """Class_Index file -> (origin idx -> contiguous idx starting at 1,
    contiguous idx -> name)."""
    originidx_to_idx: Dict[int, int] = {}
    idx_to_class: Dict[int, str] = {}
    with open(class_info_path) as f:
        rows = [ln.split() for ln in f.read().splitlines() if ln.strip()]
    for i, (origin, name) in enumerate(rows):
        originidx_to_idx[int(origin)] = i + 1
        idx_to_class[i + 1] = name
    return originidx_to_idx, idx_to_class


def get_video_info(video_info_path: str) -> Dict[str, Dict[str, float]]:
    """video_info CSV -> {video: {fps, sample_fps, count, sample_count}}."""
    infos: Dict[str, Dict[str, float]] = {}
    with open(video_info_path) as f:
        for row in csv.DictReader(f):
            vals = list(row.values())
            infos[vals[0]] = {
                'fps': float(vals[1]),
                'sample_fps': float(vals[2]),
                'count': float(vals[3]),
                'sample_count': int(float(vals[4])),
            }
    return infos


def get_video_anno(video_infos: Dict[str, dict], video_anno_path: str,
                   class_info_path: str) -> Dict[str, List[List[float]]]:
    """Annotation CSV -> {video: [[start_gt, end_gt, class_idx], ...]} in
    resampled-frame units (thumos_dataset.py:36-55)."""
    originidx_to_idx, _ = get_class_index_map(class_info_path)
    annos: Dict[str, List[List[float]]] = {}
    with open(video_anno_path) as f:
        for row in csv.reader(f):
            if not row or row[0] == 'video' or not row[0].strip():
                continue
            video = row[0]
            if video not in video_infos:
                continue
            originidx = int(row[2])
            start_frame, end_frame = float(row[-2]), float(row[-1])
            info = video_infos[video]
            ratio = info['sample_count'] * 1.0 / info['count']
            annos.setdefault(video, []).append(
                [start_frame * ratio, end_frame * ratio,
                 originidx_to_idx[originidx]])
    return annos


def boundary_heatmaps(annos: Sequence[Sequence[float]], clip_length: int
                      ) -> np.ndarray:
    """(2, clip_length) start/end GT heatmaps, widened by
    d = max(len/10, 2) (thumos_dataset.py:110-120)."""
    start = np.zeros([clip_length], np.float32)
    end = np.zeros([clip_length], np.float32)
    for s, e, _ in annos:
        d = max((e - s) / 10.0, 2.0)
        ss = np.clip(int(round(s - d / 2.0)), 0, clip_length - 1)
        se = np.clip(int(round(s + d / 2.0)), 0, clip_length - 1) + 1
        start[ss:se] = 1
        es = np.clip(int(round(e - d / 2.0)), 0, clip_length - 1)
        ee = np.clip(int(round(e + d / 2.0)), 0, clip_length - 1) + 1
        end[es:ee] = 1
    return np.stack([start, end], axis=0)


def split_videos(video_infos: Dict[str, dict],
                 video_annos: Dict[str, List[List[float]]],
                 clip_length: int = 256, stride: int = 30
                 ) -> Tuple[List[dict], Dict[str, int]]:
    """Stride the training videos into overlapping windows; keep windows
    fully containing at least one GT (thumos_dataset.py:69-129). Returns
    (clip list, per-video min action length used by SSL)."""
    training_list: List[dict] = []
    min_anno_dict: Dict[str, int] = {}
    for video_name, annos in video_annos.items():
        min_anno = float(clip_length)
        sample_count = video_infos[video_name]['sample_count']
        if sample_count <= clip_length:
            offsets = [0]
            min_anno = min(min_anno, min(a[1] - a[0] for a in annos))
        else:
            offsets = list(range(0, sample_count - clip_length + 1, stride))
            if (sample_count - clip_length) % stride:
                offsets.append(sample_count - clip_length)
        for offset in offsets:
            left, right = offset + 1, offset + clip_length
            cur_annos, keep = [], False
            for s, e, cls in annos:
                ioa = (min(right, e) - max(left, s)) / (e - s)
                if ioa >= 1.0:
                    keep = True
                if ioa >= 0.5:
                    cur_annos.append([max(s - offset, 1),
                                      min(e - offset, clip_length), cls])
            if cur_annos:
                min_anno = min(min_anno,
                               min(a[1] - a[0] for a in cur_annos))
            if keep:
                training_list.append({
                    'video_name': video_name,
                    'offset': offset,
                    'annos': cur_annos,
                    'scores': boundary_heatmaps(cur_annos, clip_length),
                })
        min_anno_dict[video_name] = int(math.ceil(min_anno))
    return training_list, min_anno_dict


def _background_region(annos, clip_length: int, min_action: int,
                       rng: random.Random) -> Optional[Tuple[int, int]]:
    """A background span longer than min_action, or None when the clip
    has none (thumos_dataset.py:173-185)."""
    spans = [[a[0], a[1]] for a in annos]
    times: List[float] = [0, clip_length - 1]
    for a in spans:
        times.extend(a)
    times.sort()
    regions = [[times[i], times[i + 1]] for i in range(len(times) - 1)]
    regions = [r for r in regions
               if r not in spans
               and math.floor(r[1]) - math.ceil(r[0]) > min_action]
    if not regions:
        return None
    region = rng.choice(regions)
    return math.ceil(region[0]), math.floor(region[1])


def ssl_augment(clip: np.ndarray, annos: List[List[float]], th: int,
                rng: random.Random,
                companions: Tuple[np.ndarray, ...] = ()):
    """Cut-paste SSL augmentation (thumos_dataset.py:187-229): move a
    background block of length `th` inside a GT segment, making two new
    boundaries. clip (T, H, W, C). Returns (augmented clip, (3, 2)
    segments [left part, right part, inserted background], success).

    `companions`, arrays with the same leading T axis (the ANet uint8
    path's pad-frame mask), take the same block moves; when given, a
    fourth element, the tuple of moved companions, is returned."""
    clip_length = clip.shape[0]
    fail = np.zeros((SSL_SEGMENTS, 2), np.float32)
    failed = ((clip, fail, False, companions) if companions
              else (clip, fail, False))
    candidates = [a for a in annos if a[1] - a[0] > 2 * th]
    if not candidates:
        return failed
    gt = rng.choice(candidates)
    gt_len = gt[1] - gt[0]
    t = rng.choice(range(math.floor(th), math.ceil(gt_len - th))) \
        + math.ceil(gt[0])
    bg = _background_region(annos, clip_length, th, rng)
    if bg is None:
        return failed
    start_idx = rng.choice(range(bg[1] - bg[0] - th)) + bg[0]
    end_idx = start_idx + th

    if gt[1] < start_idx:
        # background block right of the GT: rotate it in
        def move(arr):
            new = arr.copy()
            new[t:t + th] = arr[start_idx:end_idx]
            new[t + th:end_idx] = arr[t:start_idx]
            return new
        segs = [[gt[0], t], [t + th, th + gt[1]], [t + 1, t + th - 1]]
    else:
        def move(arr):
            new = arr.copy()
            new[start_idx:t - th] = arr[end_idx:t]
            new[t - th:t] = arr[start_idx:end_idx]
            return new
        segs = [[gt[0] - th, t - th], [t, gt[1]], [t - th + 1, t - 1]]
    segs = np.asarray(segs, np.float32)
    if companions:
        return move(clip), segs, True, tuple(move(c) for c in companions)
    return move(clip), segs, True


class ThumosTrainDataset:
    """Training windows as fixed-shape numpy samples and batches.

    Videos are memory-mapped on demand; batches are assembled on the host
    and copied to the device once per step (`data/prefetch.py`). Clips
    are float32 in [-1, 1], or raw uint8 with uint8_ingest=True, which
    `train.step.device_ingest` normalizes on the device (exact: the SSL
    cut-paste downstream only moves frame blocks). One `random.Random`
    from `seed` drives shuffle, crops, flips and SSL draws in the JAX
    package's order.
    """

    def __init__(self, npy_data_path: str, video_infos: Dict[str, dict],
                 video_annos: Dict[str, List[List[float]]],
                 clip_length: int = 256, crop_size: int = 96,
                 stride: int = 30, seed: int = 0, training: bool = True,
                 uint8_ingest: bool = False):
        self.training_list, self.min_anno = split_videos(
            video_infos, video_annos, clip_length, stride)
        self.npy_data_path = npy_data_path
        self.clip_length = clip_length
        self.crop_size = crop_size
        self.training = training
        self.uint8_ingest = uint8_ingest
        self.rng = random.Random(seed)
        self._cache: Dict[str, np.ndarray] = {}

    def __len__(self) -> int:
        return len(self.training_list)

    def _load_video(self, name: str) -> np.ndarray:
        if name not in self._cache:
            # (T, H, W, C) uint8, mmap to keep RSS bounded
            self._cache[name] = np.load(
                os.path.join(self.npy_data_path, name + '.npy'),
                mmap_mode='r')
        return self._cache[name]

    def sample(self, idx: int) -> Dict[str, np.ndarray]:
        info = self.training_list[idx]
        video = self._load_video(info['video_name'])
        offset = info['offset']
        th = self.min_anno[info['video_name']]
        clip = np.array(video[offset:offset + self.clip_length])
        if clip.shape[0] < self.clip_length:
            pad = np.zeros((self.clip_length - clip.shape[0],)
                           + clip.shape[1:], clip.dtype)
            clip = np.concatenate([clip, pad], 0)
        if self.training:
            clip = transforms.random_hflip(
                transforms.random_crop(clip, self.crop_size, self.rng),
                self.rng)
        else:
            clip = transforms.center_crop(clip, self.crop_size)
        clip = np.ascontiguousarray(clip)
        if not self.uint8_ingest:
            clip = transforms.normalize_clip(clip)

        annos = info['annos']
        ssl_clip, ssl_props, flag = ssl_augment(clip, annos, th, self.rng)

        truths = np.zeros((MAX_GT, 2), np.float32)
        labels = np.zeros((MAX_GT,), np.int32)
        gt_mask = np.zeros((MAX_GT,), bool)
        for i, (s, e, cls) in enumerate(annos[:MAX_GT]):
            truths[i] = (s / self.clip_length, e / self.clip_length)
            labels[i] = int(cls)
            gt_mask[i] = True

        return {
            'clips': clip,
            'truths': truths,
            'labels': labels,
            'gt_mask': gt_mask,
            'scores': info['scores'],
            'ssl_clips': ssl_clip,
            'ssl_props': ssl_props,
            'ssl_flags': np.float32(flag),
        }

    def batches(self, batch_size: int, shuffle: bool = True,
                drop_last: bool = True) -> Iterator[Dict[str, np.ndarray]]:
        return batches_of(self, batch_size, shuffle, drop_last)


def batches_of(dataset, batch_size: int, shuffle: bool = True,
               drop_last: bool = True) -> Iterator[Dict[str, np.ndarray]]:
    """A dataset's samples (`dataset.sample(idx)`, shuffled by its
    `rng`) stacked into batches. Spans: `loader.sample` per clip (its
    request id the sample's index) and `loader.collate`."""
    order = list(range(len(dataset)))
    if shuffle:
        dataset.rng.shuffle(order)
    for i in range(0, len(order) - (batch_size - 1 if drop_last else 0),
                   batch_size):
        chunk = []
        for j in order[i:i + batch_size]:
            with profiling.span('loader.sample', j):
                chunk.append(dataset.sample(j))
        if len(chunk) < batch_size and drop_last:
            break
        with profiling.span('loader.collate'):
            batch = {k: np.stack([s[k] for s in chunk]) for k in chunk[0]}
        yield batch
