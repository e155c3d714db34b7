"""Synthetic THUMOS-style and ActivityNet-style datasets.

The port's own numpy copies of `opental_tpu/utils/synthetic.py:70`
`make_synthetic_dataset` and `:247` `make_synthetic_anet_dataset`: a miniature but format-complete dataset (npy
videos, video-info and annotation CSVs, class index, open GT JSON, YAML
config) so that train -> test runs end to end without real data, at the
clip length, crop and frame size the caller chooses (full width for the
card: clip_length=256, crop_size=96, spatial=112).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Tuple

import numpy as np
import yaml

CLASS_NAMES = ['Run', 'Jump', 'Swim', 'Dive', 'Lift']


def tiny_train_batch(batch_size: int, frame: int = 128, crop: int = 32,
                     seed: int = 0) -> Dict[str, np.ndarray]:
    """A numpy training batch with every input the train step reads
    (clips, padded GT, heatmaps, SSL triplet inputs) at toy shapes; a
    copy of `opental_tpu/utils/synthetic.py:21` (the multichip dryrun's
    batch)."""
    rng = np.random.RandomState(seed)
    b = batch_size
    return {
        'clips': rng.randn(b, frame, crop, crop, 3).astype(np.float32),
        'truths': np.tile(np.array([[[0.1, 0.4], [0.5, 0.8]]], np.float32),
                          (b, 1, 1)),
        'labels': np.tile(np.array([[3, 7]], np.int32), (b, 1)),
        'gt_mask': np.ones((b, 2), bool),
        'scores': (rng.rand(b, 2, frame) > 0.9).astype(np.float32),
        'ssl_clips': rng.randn(b, frame, crop, crop, 3).astype(np.float32),
        'ssl_props': np.tile(
            np.array([[[10., 40.], [60., 100.], [45., 55.]]], np.float32),
            (b, 1, 1)),
        'ssl_flags': np.ones((b,), np.float32),
    }


def make_synthetic_dataset(root: str, n_train: int = 3, n_test: int = 2,
                           clip_length: int = 128, crop_size: int = 32,
                           spatial: int = 40, num_known: int = 4,
                           seed: int = 0,
                           video_len_range: Tuple[int, int] = None,
                           temporal_ramp: bool = False,
                           ensure_class_coverage: bool = False) -> str:
    """Build the dataset tree under `root`; returns the config path.

    Classes 1..num_known are known; the last class is 'unknown' (dropped
    from train annotations, kept in the open GT json). `video_len_range`
    bounds the per-video frame count (default [clip+20, clip*3)).
    `temporal_ramp` superimposes a monotone brightness ramp so that
    max-pooled features differ at every temporal position — stationary
    noise yields exactly-tied detection scores at periodic priors, which
    makes soft-NMS tie-breaking order-dependent (bad for parity tests).
    `ensure_class_coverage` makes the TEST split carry at least one GT
    segment of every class (known + unknown) — the reference evaluator
    crashes on classes absent from the ground truth.
    """
    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    anno = os.path.join(root, 'annotations')
    os.makedirs(anno, exist_ok=True)
    if num_known + 1 > len(CLASS_NAMES):
        class_names = ([f'Act{i:02d}' for i in range(1, num_known + 1)]
                       + ['MysteryAct'])
    else:
        class_names = CLASS_NAMES
    known = class_names[:num_known]
    unknown = class_names[num_known:]

    with open(os.path.join(anno, 'Class_Index_Known.txt'), 'w') as f:
        for i, name in enumerate(known):
            f.write(f'{i + 1} {name}\n')

    database: Dict[str, dict] = {}

    def gen_phase(phase: str, n_videos: int, subset: str
                  ) -> Tuple[str, str]:
        data_dir = os.path.join(root, f'{phase}_npy')
        os.makedirs(data_dir, exist_ok=True)
        info_rows = ['video,fps,sample_fps,count,sample_count']
        # column order matches the real THUMOS annotation CSVs the
        # reference parser expects (thumos_dataset.py:36-44: idx 2 is
        # the origin class index, last two are frame bounds)
        anno_rows = ['video,type,type_idx,start,end,startFrame,endFrame']
        for v in range(n_videos):
            name = f'{phase}_video_{v:03d}'
            lo, hi = (video_len_range if video_len_range is not None
                      else (clip_length + 20, clip_length * 3))
            t = int(rng.randint(lo, hi))
            video = rng.randint(0, 255, (t, spatial, spatial, 3),
                                dtype=np.uint8)
            if temporal_ramp:
                ramp = np.linspace(-50, 50, t)[:, None, None, None]
                video = np.clip(video.astype(np.int32) + ramp.astype(
                    np.int32), 0, 255).astype(np.uint8)
            anns = []
            if ensure_class_coverage and phase == 'test':
                # spread all classes round-robin across the test videos
                per = -(-len(class_names) // n_videos)
                cls_list = [(v * per + j) % len(class_names) + 1
                            for j in range(per)]
            else:
                cls_list = [int(rng.randint(1, len(class_names) + 1))
                            for _ in range(rng.randint(1, 4))]
            for cls in cls_list:
                if ensure_class_coverage and phase == 'test':
                    length = rng.randint(clip_length // 16,
                                         clip_length // 8)
                else:
                    length = rng.randint(clip_length // 8, clip_length // 2)
                start = rng.randint(0, t - length)
                cls_name = class_names[cls - 1]
                # brighten the action segment so there is signal
                video[start:start + length] = np.clip(
                    video[start:start + length].astype(np.int32) + 60,
                    0, 255).astype(np.uint8)
                anns.append((start, start + length, cls, cls_name))
            np.save(os.path.join(data_dir, name + '.npy'), video)
            fps = 10.0
            info_rows.append(f'{name},{fps},{fps},{t},{t}')
            db_anns = []
            for (s, e, cls, cls_name) in anns:
                if cls_name in known:
                    anno_rows.append(
                        f'{name},{cls_name},{cls},{s / fps:.2f},'
                        f'{e / fps:.2f},{s},{e}')
                db_anns.append({'segment': [s / fps, e / fps],
                                'label': cls_name})
            database[name] = {'subset': subset, 'annotations': db_anns}
        info_path = os.path.join(anno, f'{phase}_video_info.csv')
        with open(info_path, 'w') as f:
            f.write('\n'.join(info_rows) + '\n')
        anno_path = os.path.join(anno, f'{phase}_Annotation_known.csv')
        with open(anno_path, 'w') as f:
            f.write('\n'.join(anno_rows) + '\n')
        return info_path, anno_path

    gen_phase('val', n_train, 'validation')
    gen_phase('test', n_test, 'test')

    with open(os.path.join(anno, 'gt_open.json'), 'w') as f:
        json.dump({'database': database}, f)

    cfg = {
        'dataset': {
            'num_classes': num_known + 1,
            'class_info_path': os.path.join(anno,
                                            'Class_Index_Known.txt'),
            'training': {
                'video_info_path': os.path.join(anno,
                                                'val_video_info.csv'),
                'video_anno_path': os.path.join(
                    anno, 'val_Annotation_known.csv'),
                'video_data_path': os.path.join(root, 'val_npy'),
                'clip_length': clip_length,
                'clip_stride': clip_length // 2,
                'crop_size': crop_size,
            },
            'testing': {
                'video_info_path': os.path.join(anno,
                                                'test_video_info.csv'),
                'video_anno_path': os.path.join(
                    anno, 'test_Annotation_known.csv'),
                'video_data_path': os.path.join(root, 'test_npy'),
                'clip_length': clip_length,
                'clip_stride': clip_length // 2,
                'crop_size': crop_size,
            },
        },
        'model': {
            'in_channels': 3,
            'freeze_bn': True,
            'freeze_bn_affine': True,
            'use_edl': True,
            'evidence': 'exp',
            'dropout': 0,
            'os_head': True,
            'backbone_model': '',
        },
        'training': {
            'batch_size': 1,
            'learning_rate': 1e-4,
            'weight_decay': 1e-3,
            'max_epoch': 1,
            'focal_loss': False,
            'edl_loss': True,
            'edl_config': {
                'evidence': 'exp', 'loss_type': 'log', 'iou_aware': True,
                'with_focal': False, 'alpha': 0.25, 'gamma': 2,
                'with_ibm': True, 'ibm_start': 10, 'momentum': 0.99,
                'num_bins': 50,
            },
            'act_config': {'margin': 1.0, 'weight': 0},
            'checkpoint_path': os.path.join(root, 'models'),
            'random_seed': 2020,
        },
        'testing': {
            'conf_thresh': 0.01,
            'top_k': 200,
            'nms_thresh': 0.5,
            'nms_sigma': 0.5,
            'fusion': False,
            # the port's training writes checkpoint-<epoch>.ckpt and
            # this link to the newest (train/checkpoint.py)
            'checkpoint_path': os.path.join(root, 'models',
                                            'checkpoint-latest.ckpt'),
            'output_path': os.path.join(root, 'output'),
            'output_json': 'detection_results.json',
        },
    }
    cfg_path = os.path.join(root, 'config.yaml')
    with open(cfg_path, 'w') as f:
        yaml.safe_dump(cfg, f)
    return cfg_path


def make_synthetic_anet_dataset(root: str, n_train: int = 2,
                                n_val: int = 2, clip_length: int = 256,
                                crop_size: int = 32, spatial: int = 40,
                                num_known: int = 4, seed: int = 0) -> str:
    """ANet-format miniature dataset: v_*.npy single-window videos, a
    video_info JSON (anet_data/gen_video_info.py schema: subset,
    frame_num, fps, duration, annotations[{label_id, start_frame,
    end_frame, label}]), an action_known.txt class file, an open GT JSON,
    and a reference-schema YAML config (configs/anet_opental.yaml).
    Returns the config path. Validation videos may carry unknown-class
    segments (kept in the GT, absent from the class file)."""
    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    anno = os.path.join(root, 'annotations')
    data_dir = os.path.join(root, 'npy')
    os.makedirs(anno, exist_ok=True)
    os.makedirs(data_dir, exist_ok=True)
    known = [f'Act{i:02d}' for i in range(1, num_known + 1)]
    unknown_name = 'MysteryAct'
    with open(os.path.join(anno, 'action_known.txt'), 'w') as f:
        f.write('\n'.join(known) + '\n')

    fps = 5.0
    video_info: Dict[str, dict] = {}
    database: Dict[str, dict] = {}

    def gen(subset: str, n: int) -> None:
        for v in range(n):
            name = f'v_{subset}_{v:03d}'
            t = int(rng.randint(clip_length // 2, clip_length + 1))
            video = rng.randint(0, 255, (t, spatial, spatial, 3),
                                dtype=np.uint8)
            anns, db_anns = [], []
            for _ in range(rng.randint(1, 3)):
                length = rng.randint(clip_length // 8, clip_length // 3)
                start = rng.randint(0, max(t - length, 1))
                end = min(start + length, t)
                openset_unknown = (subset == 'validation'
                                   and rng.rand() < 0.3)
                cid = 0 if openset_unknown else int(
                    rng.randint(1, num_known + 1))
                label = unknown_name if openset_unknown else known[cid - 1]
                video[start:end] = np.clip(
                    video[start:end].astype(np.int32) + 60, 0,
                    255).astype(np.uint8)
                if not openset_unknown or subset == 'validation':
                    anns.append({'label_id': cid, 'label': label,
                                 'start_frame': int(start),
                                 'end_frame': int(end)})
                db_anns.append({'segment': [start / fps, end / fps],
                                'label': label})
            np.save(os.path.join(data_dir, name + '.npy'), video)
            video_info[name] = {
                'subset': subset, 'frame_num': t, 'fps': fps,
                'duration': t / fps,
                'annotations': anns,
            }
            database[name[2:]] = {'subset': subset,
                                  'annotations': db_anns}

    gen('training', n_train)
    gen('validation', n_val)

    info_path = os.path.join(anno, 'video_info.json')
    with open(info_path, 'w') as f:
        json.dump(video_info, f)
    with open(os.path.join(anno, 'gt_open.json'), 'w') as f:
        json.dump({'database': database}, f)

    cfg = {
        'dataset': {
            'num_classes': num_known + 1,
            'class_info_path': os.path.join(anno, 'action_known.txt'),
            'training': {
                'video_mp4_path': data_dir,
                'video_info_path': info_path,
                'video_data_path': data_dir,
                'clip_length': clip_length,
                'clip_stride': clip_length,
                'crop_size': crop_size,
            },
            'testing': {
                'video_mp4_path': data_dir,
                'video_info_path': info_path,
                'video_data_path': data_dir,
                'clip_length': clip_length,
                'clip_stride': clip_length,
                'crop_size': crop_size,
            },
        },
        'model': {
            'in_channels': 3, 'arch': 'anet', 'freeze_bn': True,
            'freeze_bn_affine': True, 'use_edl': True, 'evidence': 'exp',
            'os_head': True, 'backbone_model': '',
        },
        'training': {
            'batch_size': 2, 'learning_rate': 1e-4, 'weight_decay': 1e-4,
            'max_epoch': 1, 'focal_loss': False, 'edl_loss': True,
            'edl_config': {
                'evidence': 'exp', 'loss_type': 'log', 'soft_label': 0,
                'with_focal': False, 'alpha': 0.25, 'gamma': 2,
                'iou_aware': True, 'with_ibm': True, 'ibm_start': 10,
                'momentum': 0.99, 'num_bins': 50,
            },
            'checkpoint_path': os.path.join(root, 'models'),
            'random_seed': 2020,
        },
        'testing': {
            'conf_thresh': 0.01, 'top_k': 100, 'nms_thresh': 0.5,
            'nms_sigma': 0.85, 'fusion': False,
            'checkpoint_path': os.path.join(root, 'models',
                                            'checkpoint-latest.ckpt'),
            'output_path': os.path.join(root, 'output'),
            'output_json': 'detection_results.json',
        },
    }
    cfg_path = os.path.join(root, 'config.yaml')
    with open(cfg_path, 'w') as f:
        yaml.safe_dump(cfg, f)
    return cfg_path
