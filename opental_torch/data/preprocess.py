"""Offline preprocessing: mp4 -> resampled uint8 npy + video info.

Reference: AFSD/common/video2npy.py (THUMOS: fps-resampled 112x112
frames + video_info CSV), AFSD/anet_data/video2npy.py (ANet: 768-frame
cap, multiprocess sharded), AFSD/common/gen_denseflow_npy.py (TVL1
optical flow clipped to +-20).

npy layout is (T, H, W, C) uint8 — identical to the reference files, so
preprocessed datasets are interchangeable. Decoding uses OpenCV; flow
requires the contrib DualTVL1 implementation and degrades with a clear
error when absent.

Copy of `opental_tpu/data/preprocess.py`: numpy, OpenCV and files only;
`videos_to_npy`'s process pool spawns its workers.
"""

from __future__ import annotations

import csv
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from typing import List, Optional, Sequence, Tuple

import numpy as np


def _require_cv2():
    try:
        import cv2
        return cv2
    except ImportError as e:  # pragma: no cover
        raise RuntimeError(
            'opencv is required for mp4 decoding (video_to_npy)') from e


def resample_indices_stream(fps: float, sample_fps: float, count: int
                            ) -> np.ndarray:
    """Frame indices kept by the reference's streaming resampler
    (video2npy.py:46-63): accumulate 1 per frame, emit when the
    accumulator crosses step = fps / sample_fps."""
    step = fps / sample_fps
    cur = 0.0
    keep = []
    for i in range(count):
        cur += 1.0
        if cur >= step:
            cur -= step
            keep.append(i)
    return np.asarray(keep, np.int64)


def video_to_npy(mp4_path: str, out_npy: str, sample_fps: float = 10.0,
                 resolution: int = 112, max_frames: Optional[int] = None
                 ) -> Tuple[float, int, int]:
    """Decode + resample one video. Returns (fps, count, sample_count)."""
    cv2 = _require_cv2()
    cap = cv2.VideoCapture(mp4_path)
    if not cap.isOpened():
        raise IOError(f'{mp4_path} open failed')
    fps = cap.get(cv2.CAP_PROP_FPS)
    if fps <= 0:
        raise ValueError(f'{mp4_path}: bad fps {fps}')
    step = fps / sample_fps if fps >= sample_fps else 1.0
    cur = 0.0
    frames: List[np.ndarray] = []
    count = 0
    while True:
        ret, frame = cap.read()
        if not ret:
            break
        count += 1
        cur += 1.0
        if cur >= step:
            cur -= step
            img = cv2.resize(frame[:, :, ::-1], (resolution, resolution),
                             interpolation=cv2.INTER_CUBIC)
            frames.append(img.astype(np.uint8))
            if max_frames is not None and len(frames) >= max_frames:
                break
    cap.release()
    data = np.stack(frames, 0)
    os.makedirs(os.path.dirname(os.path.abspath(out_npy)), exist_ok=True)
    np.save(out_npy, data)
    return float(fps), count, len(frames)


def videos_to_npy(mp4_dir: str, out_dir: str, video_names: Sequence[str],
                  sample_fps: float = 10.0, resolution: int = 112,
                  video_info_csv: Optional[str] = None,
                  max_frames: Optional[int] = None,
                  workers: int = 1) -> None:
    """Batch conversion with optional multiprocess sharding
    (anet_data/video2npy.py:48-62) and video_info CSV export."""
    os.makedirs(out_dir, exist_ok=True)
    jobs = [(os.path.join(mp4_dir, name + '.mp4'),
             os.path.join(out_dir, name + '.npy')) for name in video_names]
    infos = []
    if workers > 1:
        # spawned, not forked: the caller may hold threads (torch's pool,
        # OpenCV's), and a forked child can inherit one of their locks
        with ProcessPoolExecutor(
                max_workers=workers,
                mp_context=multiprocessing.get_context('spawn')) as pool:
            futures = [pool.submit(video_to_npy, src, dst, sample_fps,
                                   resolution, max_frames)
                       for src, dst in jobs]
            for name, fut in zip(video_names, futures):
                fps, count, save_count = fut.result()
                infos.append([name, fps, sample_fps, count, save_count])
    else:
        for name, (src, dst) in zip(video_names, jobs):
            fps, count, save_count = video_to_npy(src, dst, sample_fps,
                                                  resolution, max_frames)
            infos.append([name, fps, sample_fps, count, save_count])
    if video_info_csv:
        with open(video_info_csv, 'w', newline='') as f:
            w = csv.writer(f)
            w.writerow(['video', 'fps', 'sample_fps', 'count',
                        'sample_count'])
            w.writerows(infos)


def flow_to_npy(rgb_npy: str, out_npy: str, bound: float = 20.0) -> None:
    """TVL1 optical flow of a preprocessed npy video, clipped to
    [-bound, bound] and stored as uint8 (gen_denseflow_npy.py:10-123)."""
    cv2 = _require_cv2()
    if not hasattr(cv2, 'optflow'):
        raise RuntimeError('cv2.optflow (opencv-contrib) is required for '
                           'TVL1 flow extraction')
    tvl1 = cv2.optflow.DualTVL1OpticalFlow_create()
    video = np.load(rgb_npy)
    grays = [cv2.cvtColor(f, cv2.COLOR_RGB2GRAY) for f in video]
    flows = []
    for i in range(len(grays)):
        prev_i = max(i - 1, 0)
        flow = tvl1.calc(grays[prev_i], grays[i], None)
        flow = np.clip(flow, -bound, bound)
        # [-bound, bound] -> [0, 255] uint8, decoded back by the loader
        flows.append(((flow + bound) * (255.0 / (2 * bound))
                      ).astype(np.uint8))
    np.save(out_npy, np.stack(flows, 0))


def anet_video_info(npy_dir: str, anno_json: str, out_json: str,
                    clip_length: int = 768) -> None:
    """Build the ANet video_info JSON consumed by data.anet
    (anet_data/gen_video_info.py semantics: per-video fps scaled so the
    whole video maps into <= clip_length frames)."""
    import json
    with open(anno_json) as f:
        db = json.load(f)['database']
    out = {}
    for vid, v in db.items():
        name = 'v_' + vid if not vid.startswith('v_') else vid
        npy = os.path.join(npy_dir, name + '.npy')
        if not os.path.exists(npy):
            continue
        frame_num = int(np.load(npy, mmap_mode='r').shape[0])
        duration = float(v['duration'])
        fps = frame_num / duration
        annotations = [{
            'label': a['label'],
            'label_id': a.get('label_id', 0),
            'start_frame': a['segment'][0] * fps,
            'end_frame': a['segment'][1] * fps,
            'segment': a['segment'],
        } for a in v['annotations']]
        out[name] = {
            'subset': v['subset'],
            'fps': fps,
            'duration': duration,
            'frame_num': frame_num,
            'annotations': annotations,
        }
    with open(out_json, 'w') as f:
        json.dump(out, f)
