"""ActivityNet dataset: JSON video info, one 768-frame window per video.

The port's copy of the host-side numpy `opental_tpu/data/anet.py`
(reference AFSD/common/anet_dataset.py): one zero-offset window per
video, per-item npy load, pad value 127.5, (action, start, end) GT
heatmaps carrying class ids, and the THUMOS SSL cut-paste augmentation
(`data.thumos.ssl_augment`). One `random.Random` from `seed` draws
shuffle, crops, flips and SSL in the JAX package's order.
"""

from __future__ import annotations

import json
import math
import os
import random
from typing import Dict, Iterator, List

import numpy as np

from opental_torch.data import transforms
from opental_torch.data.thumos import MAX_GT, batches_of, ssl_augment


def get_video_info(video_info_path: str, subset: str = 'training'
                   ) -> Dict[str, dict]:
    with open(video_info_path) as f:
        data = json.load(f)
    return {k: v for k, v in data.items() if v['subset'] == subset}


def heatmaps(annos: List[List[float]], clip_length: int) -> np.ndarray:
    """(3, T) action / start / end heatmaps carrying class-id values
    (anet_dataset.py:78-92)."""
    start = np.zeros([clip_length], np.float32)
    end = np.zeros([clip_length], np.float32)
    action = np.zeros([clip_length], np.float32)
    for s, e, cid in annos:
        d = max((e - s) / 10.0, 2.0)
        a_s = np.clip(int(round(s)), 0, clip_length - 1)
        a_e = np.clip(int(round(e)), 0, clip_length - 1) + 1
        action[a_s:a_e] = cid
        s_s = np.clip(int(round(s - d / 2)), 0, clip_length - 1)
        s_e = np.clip(int(round(s + d / 2)), 0, clip_length - 1) + 1
        start[s_s:s_e] = cid
        e_s = np.clip(int(round(e - d / 2)), 0, clip_length - 1)
        e_e = np.clip(int(round(e + d / 2)), 0, clip_length - 1) + 1
        end[e_s:e_e] = cid
    return np.stack([action, start, end], axis=0)


def split_videos(video_info: Dict[str, dict], clip_length: int,
                 video_dir: str, binary_class: bool = False):
    """One zero-offset window per video with valid annotations
    (anet_dataset.py:43-104). Returns (window list, per-video shortest
    action, the SSL block length before its / 4)."""
    training_list, min_anno_dict = [], {}
    for video_name, info in video_info.items():
        if not os.path.exists(os.path.join(video_dir, video_name + '.npy')):
            continue
        annos = []
        for anno in info['annotations']:
            label_id = anno['label_id']
            if binary_class:
                label_id = 1 if label_id > 0 else 0
            if anno['end_frame'] <= anno['start_frame']:
                continue
            annos.append([anno['start_frame'], anno['end_frame'],
                          label_id])
        if not annos:
            continue
        min_anno = min(float(clip_length), min(a[1] - a[0] for a in annos))
        training_list.append({
            'video_name': video_name,
            'offset': 0,
            'annos': annos,
            'frame_num': min(info['frame_num'], clip_length),
            'scores': heatmaps(annos, clip_length),
        })
        min_anno_dict[video_name] = math.floor(min_anno)
    return training_list, min_anno_dict


def _gt_tensors(annos, clip_length: int):
    truths = np.zeros((MAX_GT, 2), np.float32)
    labels = np.zeros((MAX_GT,), np.int32)
    gt_mask = np.zeros((MAX_GT,), bool)
    for i, (s, e, cid) in enumerate(annos[:MAX_GT]):
        truths[i] = (s / clip_length, e / clip_length)
        labels[i] = int(cid)
        gt_mask[i] = True
    return truths, labels, gt_mask


class AnetTrainDataset:
    """ANet training windows as fixed-shape numpy samples and batches.

    Short videos are padded with 127.5 (anet_dataset.py:231-234). With
    uint8_ingest=True the clips stay raw uint8 and the pad is 0 with a
    per-frame `pad_masks` companion (and `ssl_pad_masks`, moved with the
    SSL cut-paste's frame blocks): 127.5 normalizes to exactly 0.0, so
    `train.step.device_ingest`'s where(pad, 0, x) after normalizing on the
    device gives the f32 path's clip.
    """

    def __init__(self, video_info_path: str, video_dir: str,
                 clip_length: int = 768, crop_size: int = 96,
                 training: bool = True, binary_class: bool = False,
                 seed: int = 0, uint8_ingest: bool = False):
        subset = 'training' if training else 'validation'
        info = get_video_info(video_info_path, subset)
        self.training_list, self.th = split_videos(info, clip_length,
                                                   video_dir, binary_class)
        self.video_dir = video_dir
        self.clip_length = clip_length
        self.crop_size = crop_size
        self.training = training
        self.uint8_ingest = uint8_ingest
        self.rng = random.Random(seed)

    def __len__(self) -> int:
        return len(self.training_list)

    def _crop(self, frames: np.ndarray) -> np.ndarray:
        if self.training:
            return transforms.random_hflip(
                transforms.random_crop(frames, self.crop_size, self.rng),
                self.rng)
        return transforms.center_crop(frames, self.crop_size)

    def sample(self, idx: int) -> Dict[str, np.ndarray]:
        info = self.training_list[idx]
        th = max(int(self.th[info['video_name']] / 4), 1)
        data = np.load(os.path.join(self.video_dir,
                                    info['video_name'] + '.npy'))
        end = min(info['offset'] + self.clip_length, info['frame_num'])
        frames = data[info['offset']:end]
        t = frames.shape[0]
        annos = info['annos']
        truths, labels, gt_mask = _gt_tensors(annos, self.clip_length)
        out = {'truths': truths, 'labels': labels, 'gt_mask': gt_mask,
               'scores': info['scores']}
        if self.uint8_ingest:
            if frames.dtype != np.uint8:
                raise ValueError('uint8_ingest requires uint8 npy sources, '
                                 f'got {frames.dtype}')
            pad_mask = np.zeros((self.clip_length,), np.uint8)
            if t < self.clip_length:
                frames = np.concatenate([frames, np.zeros(
                    (self.clip_length - t,) + frames.shape[1:], np.uint8)])
                pad_mask[t:] = 1
            clip = np.ascontiguousarray(self._crop(frames))
            ssl_clip, ssl_props, flag, (ssl_pad_mask,) = ssl_augment(
                clip, annos, th, self.rng, companions=(pad_mask,))
            out.update(clips=clip, pad_masks=pad_mask,
                       ssl_clips=np.ascontiguousarray(ssl_clip),
                       ssl_pad_masks=ssl_pad_mask)
        else:
            frames = frames.astype(np.float32)
            if t < self.clip_length:
                frames = np.concatenate([frames, np.full(
                    (self.clip_length - t,) + frames.shape[1:], 127.5,
                    np.float32)])
            clip = (np.ascontiguousarray(self._crop(frames)) / 255.0) \
                * 2.0 - 1.0
            ssl_clip, ssl_props, flag = ssl_augment(clip, annos, th,
                                                    self.rng)
            out.update(clips=clip.astype(np.float32),
                       ssl_clips=ssl_clip.astype(np.float32))
        out.update(ssl_props=ssl_props, ssl_flags=np.float32(flag))
        return out

    def batches(self, batch_size: int, shuffle: bool = True,
                drop_last: bool = True) -> Iterator[Dict[str, np.ndarray]]:
        return batches_of(self, batch_size, shuffle, drop_last)
