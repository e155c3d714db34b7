"""Seeded traffic: the frame bank, video lengths, and the training trees.

One general generator per kind, driven by a traffic mix's parameters
(`workloads/*.json`). The same seed gives the same inputs. Every seed
draws its lengths from the same fixed set (quantiles of the mix's
distribution), in another order, so that seeds change the data and not
the amount of work.

The frames carry a slow triangular brightness ramp over uniform noise
(the idea of the port's `utils/synthetic.py` `temporal_ramp`, at real
widths): stationary noise ties detection scores at periodic priors,
which makes soft-NMS depend on tie order.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import random
from statistics import NormalDist
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch

RAMP_PERIOD = 4096        # frames from one ramp peak to the next
RAMP_AMPLITUDE = 30       # grey levels either side of the noise's centre
NOISE_LEVELS = 196        # noise in [30, 225] before the ramp


def subseed(seed: int, tag: str) -> int:
    """An independent 60-bit seed for one use of the run's seed."""
    digest = hashlib.sha256(f'{int(seed)}:{tag}'.encode()).hexdigest()
    return int(digest[:15], 16)


def generator(seed: int, tag: str, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(subseed(seed, tag))


def ramp(frames: int, start: int = 0) -> torch.Tensor:
    """(frames,) int16 triangular ramp in [-RAMP_AMPLITUDE, +], period
    RAMP_PERIOD."""
    t = torch.arange(start, start + frames, dtype=torch.float64)
    phase = (t / (RAMP_PERIOD / 2)) % 2.0
    tri = 1.0 - (phase - 1.0).abs()                  # 0 -> 1 -> 0
    return torch.round((2.0 * tri - 1.0) * RAMP_AMPLITUDE).to(torch.int16)


def frames(seed: int, tag: str, n: int, spatial: int,
           device: torch.device, start: int = 0) -> np.ndarray:
    """(n, spatial, spatial, 3) uint8 frames on the host, made on
    `device` from the seed: noise in [30, 225] plus the ramp at frame
    indices start .. start + n."""
    g = generator(seed, tag, device)
    noise = torch.randint(0, NOISE_LEVELS, (n, spatial, spatial, 3),
                          generator=g, device=device, dtype=torch.int16)
    r = ramp(n, start).to(device)[:, None, None, None]
    out = (noise + (255 - NOISE_LEVELS) // 2 + 1 + r).clamp(0, 255)
    return out.to(torch.uint8).cpu().numpy()


def length_set(spec: Dict[str, Any]) -> List[int]:
    """The mix's fixed set of video lengths: `quantiles` evenly spaced
    quantiles of its distribution, clipped to [min, max] frames.
    `lognormal` takes `median` and `sigma`; `uniform` its bounds."""
    q = int(spec['quantiles'])
    ps = [(i + 0.5) / q for i in range(q)]
    lo, hi = int(spec['min']), int(spec['max'])
    if spec['dist'] == 'lognormal':
        mu, sigma = math.log(spec['median']), float(spec['sigma'])
        vals = [math.exp(mu + sigma * NormalDist().inv_cdf(p)) for p in ps]
    elif spec['dist'] == 'uniform':
        vals = [lo + (hi - lo) * p for p in ps]
    else:
        raise ValueError(f'length distribution {spec["dist"]!r}')
    return [min(hi, max(lo, int(round(v)))) for v in vals]


def lengths(spec: Dict[str, Any], seed: int) -> Iterator[int]:
    """Endless lengths: the fixed set, shuffled anew for each pass."""
    rng = random.Random(subseed(seed, 'lengths'))
    base = length_set(spec)
    while True:
        order = list(base)
        rng.shuffle(order)
        yield from order


class VideoSource:
    """Videos as views into one seeded frame bank: video i takes
    lengths[i] frames from a seeded start, so each is a contiguous piece
    of the ramped bank."""

    def __init__(self, traffic: Dict[str, Any], seed: int,
                 device: torch.device, bank: Optional[np.ndarray] = None):
        self.fps = float(traffic['fps'])
        self.bank = bank if bank is not None else frames(
            seed, 'bank', int(traffic['bank_frames']),
            int(traffic['spatial']), device)
        self.lengths = lengths(traffic['lengths'], seed)
        self.rng = random.Random(subseed(seed, 'starts'))
        self.count = 0

    def next(self):
        """(name, frames (T, H, W, 3) uint8 view, sample_count, fps,
        start in the bank)."""
        n = next(self.lengths)
        start = self.rng.randrange(0, len(self.bank) - n + 1)
        name = f'video_{self.count:05d}'
        self.count += 1
        return name, self.bank[start:start + n], n, self.fps, start


# ------------------------------------------------------------- train trees

def _draw_gts(rng: random.Random, n_frames: int, n_gt: int,
              gt_len: List[int]) -> List[List[int]]:
    """n_gt non-overlapping [start, end) frame segments."""
    out: List[List[int]] = []
    for _ in range(100 * n_gt):
        if len(out) == n_gt:
            break
        length = min(rng.randint(*gt_len), n_frames - 1)
        s = rng.randrange(0, n_frames - length)
        if all(s + length <= a or s >= b for a, b in out):
            out.append([s, s + length])
    return sorted(out)


def _brighten(video: np.ndarray, segs: List[List[int]]) -> None:
    for s, e in segs:
        video[s:e] = np.minimum(video[s:e].astype(np.int16) + 20,
                                255).astype(np.uint8)


def thumos_tree(root: str, seed: int, spec: Dict[str, Any],
                num_known: int, spatial: int, device: torch.device
                ) -> Dict[str, str]:
    """A THUMOS14-schema training tree (npy videos at 10 fps, the video
    info and known-class annotation CSVs, the known-class index). Returns
    the dataset paths to put into the configuration."""
    rng = random.Random(subseed(seed, 'thumos_tree'))
    anno = os.path.join(root, 'annotations')
    data = os.path.join(root, 'val_npy')
    os.makedirs(anno, exist_ok=True)
    os.makedirs(data, exist_ok=True)
    origin = list(range(1, num_known + 1))
    class_path = os.path.join(anno, 'Class_Index_Known.txt')
    with open(class_path, 'w') as f:
        f.write(''.join(f'{o} Act{o:02d}\n' for o in origin))
    info = ['video,fps,sample_fps,count,sample_count']
    rows = ['video,type,type_idx,start,end,startFrame,endFrame']
    fps = 10.0
    for v in range(int(spec['videos'])):
        name = f'video_validation_{v:07d}'
        t = rng.randint(*spec['frames'])
        video = frames(seed, f'thumos_tree_{v}', t, spatial, device)
        segs = _draw_gts(rng, t, rng.randint(*spec['gt_per_video']),
                         spec['gt_frames'])
        _brighten(video, segs)
        np.save(os.path.join(data, name + '.npy'), video)
        info.append(f'{name},{fps},{fps},{t},{t}')
        for s, e in segs:
            o = rng.choice(origin)
            rows.append(f'{name},Act{o:02d},{o},{s / fps:.2f},{e / fps:.2f},'
                        f'{s},{e}')
    info_path = os.path.join(anno, 'val_video_info.csv')
    anno_path = os.path.join(anno, 'val_Annotation_known.csv')
    with open(info_path, 'w') as f:
        f.write('\n'.join(info) + '\n')
    with open(anno_path, 'w') as f:
        f.write('\n'.join(rows) + '\n')
    return {'dataset.class_info_path': class_path,
            'dataset.training.video_info_path': info_path,
            'dataset.training.video_anno_path': anno_path,
            'dataset.training.video_data_path': data}


def anet_tree(root: str, seed: int, spec: Dict[str, Any], num_known: int,
              spatial: int, device: torch.device) -> Dict[str, str]:
    """An ActivityNet-schema training tree (v_*.npy videos, the
    video-info JSON with frame-unit annotations of known class ids).
    Returns the dataset paths to put into the configuration."""
    rng = random.Random(subseed(seed, 'anet_tree'))
    anno = os.path.join(root, 'annotations')
    data = os.path.join(root, 'npy')
    os.makedirs(anno, exist_ok=True)
    os.makedirs(data, exist_ok=True)
    class_path = os.path.join(anno, 'action_known.txt')
    with open(class_path, 'w') as f:
        f.write(''.join(f'Act{i:03d}\n' for i in range(1, num_known + 1)))
    infos = {}
    for v in range(int(spec['videos'])):
        name = f'v_train_{v:05d}'
        t = rng.randint(*spec['frames'])
        video = frames(seed, f'anet_tree_{v}', t, spatial, device)
        segs = _draw_gts(rng, t, rng.randint(*spec['gt_per_video']),
                         spec['gt_frames'])
        _brighten(video, segs)
        np.save(os.path.join(data, name + '.npy'), video)
        anns = []
        for s, e in segs:
            cid = rng.randint(1, num_known)
            anns.append({'label_id': cid, 'label': f'Act{cid:03d}',
                         'start_frame': s, 'end_frame': e})
        infos[name] = {'subset': 'training', 'frame_num': t, 'fps': 5.0,
                       'duration': t / 5.0, 'annotations': anns}
    info_path = os.path.join(anno, 'video_info.json')
    with open(info_path, 'w') as f:
        json.dump(infos, f)
    return {'dataset.class_info_path': class_path,
            'dataset.training.video_info_path': info_path,
            'dataset.training.video_data_path': data,
            'dataset.training.video_mp4_path': data}
