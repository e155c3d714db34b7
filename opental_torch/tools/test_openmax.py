"""OpenMax baseline CLI: python -m opental_torch.tools.test_openmax
<cfg.yaml> [flags] [--cross_data] [--device cuda|cpu].

Counterpart of `opental_tpu/tools/test_openmax.py` (reference
AFSD/thumos14/test_openmax.py), three idempotent stages:
 1. MAVs: the trained closed-set model (`configs/thumos14_openmax.yaml`:
    softmax heads, no os_head, no EDL) with its `get_feat` taps over the
    training clips, shipped as raw uint8 and normalized on the device;
    per class the MAV and eucos distances of the positively matched
    priors' features, saved under `<output_path>/mav_dist/` (:248-327);
 2. the Weibull fit of each class's top-20 distance tail (:331-354);
 3. test-time inference with each proposal's logits recalibrated
    (the unknown mass takes the background slot, :358-403,
    openmax.py:42-86), to the detection JSON. Each stage's Weibull model
    reads that stage's own features (`PARITY.md`).
`--cross_data` runs stage 3 over the ActivityNet unknowns too and merges
the two result sets (reference test_openmax_cross_data.py). Runs on the
card unless `--device cpu` (or device='cpu') is asked for.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from opental_torch import factory, resolve_device
from opental_torch.config import (Config, build_arg_parser,
                                  config_from_namespace)
from opental_torch.data import transforms
from opental_torch.data.anet import get_video_info as get_anet_video_info
from opental_torch.data.thumos import (ThumosTrainDataset,
                                       get_class_index_map, get_video_anno,
                                       get_video_info)
from opental_torch.infer.pipeline import (ingest_windows, stack_windows_u8,
                                          window_offsets)
from opental_torch.openset.openmax import (OpenMax, accumulate_mavs,
                                           extract_positive_features,
                                           save_mav_dist, weibull_fitting)
from opental_torch.ops.nms import soft_nms_numpy
from opental_torch.tools.test import load_variables
from opental_torch.tools.test_cross_data import exclude_overlapping

Device = Optional[Union[str, torch.device]]
MAX_BATCH = 32          # windows per forward


def closed_set_model(cfg: Config, frame_num: int, crop_size: int,
                     device: torch.device) -> torch.nn.Module:
    """The config's model with `testing.checkpoint_path` loaded, on
    `device`; OpenMax needs the closed-set softmax architecture."""
    model = factory.build_model(cfg, frame_num=frame_num,
                                crop_size=crop_size)
    if model.os_head or model.use_edl:
        raise ValueError(
            'OpenMax is a closed-set softmax baseline: it recalibrates '
            'background-column logits (test_openmax.py:158) and the '
            'reference openmax config sets neither os_head nor EDL '
            '(configs/thumos14_openmax.yaml). Use tools.test for os_head '
            '/ EDL checkpoints.')
    load_variables(model, cfg.testing['checkpoint_path'])
    return model.to(device).eval()


def compute_mav_dist(cfg: Config, mav_dist_dir: str,
                     max_clips: Optional[int] = None,
                     device: Device = None) -> None:
    """Stage 1: per-class MAVs and distances over the training clips."""
    clip_length = cfg.get_path('dataset.training.clip_length', 256)
    crop_size = cfg.get_path('dataset.training.crop_size', 96)
    model = closed_set_model(cfg, clip_length, crop_size,
                             resolve_device(device))
    _, idx_to_class = get_class_index_map(
        cfg.get_path('dataset.class_info_path'))
    infos = get_video_info(cfg.get_path(
        'dataset.training.video_info_path'))
    annos = get_video_anno(infos,
                           cfg.get_path('dataset.training.video_anno_path'),
                           cfg.get_path('dataset.class_info_path'))
    dataset = ThumosTrainDataset(
        cfg.get_path('dataset.training.video_data_path'), infos, annos,
        clip_length=clip_length, crop_size=crop_size,
        stride=cfg.get_path('dataset.training.clip_stride', 30),
        training=False, uint8_ingest=True)

    def batch_iter():
        n = len(dataset) if max_clips is None else min(max_clips,
                                                       len(dataset))
        for i in range(n):
            s = dataset.sample(i)
            yield {k: v[None] for k, v in s.items()
                   if k in ('clips', 'truths', 'labels', 'gt_mask')}

    coarse, refined = extract_positive_features(
        model, batch_iter(), clip_length, idx_to_class,
        overlap_thresh=cfg.get_path('training.piou', 0.5) or 0.5)
    save_mav_dist(mav_dist_dir, accumulate_mavs(coarse),
                  accumulate_mavs(refined),
                  class_names=list(idx_to_class.values()))


class OpenMaxInference:
    """Stages 2 and 3: the Weibull fit, then recalibrated window-batched
    inference, shared by the in-domain and cross-data runs. Windows
    are staged as raw uint8 with per-window frames-valid and normalized
    on the device, `MAX_BATCH` per forward."""

    def __init__(self, cfg: Config, mav_dist_dir: str, tailsize: int = 20,
                 device: Device = None):
        te = cfg.testing
        self.device = resolve_device(device)
        self.clip_length = cfg.get_path('dataset.testing.clip_length', 256)
        self.crop_size = cfg.get_path('dataset.testing.crop_size', 96)
        self.stride = cfg.get_path('dataset.testing.clip_stride', 128)
        self.conf_thresh = te.get('conf_thresh', 0.01)
        self.nms_sigma = te.get('nms_sigma', 0.5)
        self.top_k = te.get('top_k', 5000)
        self.model = closed_set_model(cfg, self.clip_length, self.crop_size,
                                      self.device)
        _, self.idx_to_class = get_class_index_map(
            cfg.get_path('dataset.class_info_path'))
        self.num_classes = self.model.head_classes
        class_names = [self.idx_to_class[i]
                       for i in sorted(self.idx_to_class)]
        wm, wpm = weibull_fitting(mav_dist_dir, class_names, tailsize)
        self.openmax = OpenMax(wm)
        self.openmax_prop = OpenMax(wpm)

    def forward(self, clips: torch.Tensor) -> List[np.ndarray]:
        """(W, C, T, H, W) clips -> host (segments, conf, prop_conf,
        sigmoid(center), conf_feat, prop_conf_feat)."""
        clip_length = self.clip_length
        with torch.inference_mode():
            out = self.model(clips, get_feat=True)
            loc, prop_loc = out['loc'].float(), out['prop_loc'].float()
            fused = 0.5 * (loc[..., :1] + loc[..., 1:]) * prop_loc + loc
            priors = out['priors'][None, :, :1]
            segs = torch.clamp(torch.cat(
                [priors * clip_length - fused[..., :1],
                 priors * clip_length + fused[..., 1:]], -1), 0,
                clip_length)
            outs = (segs, out['conf'], out['prop_conf'],
                    torch.sigmoid(out['center'][..., 0]),
                    out['conf_feat'], out['prop_conf_feat'])
            return [a.float().cpu().numpy() for a in outs]

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def run_video(self, data: np.ndarray, sample_count: int,
                  sample_fps: float) -> List[dict]:
        data = transforms.center_crop(data, self.crop_size)
        offsets = window_offsets(sample_count, self.clip_length,
                                 self.stride)
        clips, valid = stack_windows_u8(data, offsets, self.clip_length)
        parts = [self.forward(ingest_windows(
            self._to_device(clips[i:i + MAX_BATCH]),
            self._to_device(valid[i:i + MAX_BATCH])))
            for i in range(0, len(offsets), MAX_BATCH)]
        segs, conf, prop_conf, center, feat, prop_feat = [
            np.concatenate(p) for p in zip(*parts)]
        n = len(offsets)
        seconds = (segs + np.asarray(offsets, np.float32)[:, None, None]) \
            / sample_fps

        # OpenMax recalibration: drop the background logit column, the
        # unknown mass takes its slot (test_openmax.py:158)
        p, k = conf.shape[1], conf.shape[2]
        probs = self.openmax(
            conf[..., 1:].reshape(-1, k - 1),
            feat.reshape(-1, feat.shape[-1])).reshape(n, p, k)
        prop_probs = self.openmax_prop(
            prop_conf[..., 1:].reshape(-1, k - 1),
            prop_feat.reshape(-1, prop_feat.shape[-1])).reshape(n, p, k)
        scores = (probs + prop_probs) / 2.0 * center[..., None]

        seconds_flat = seconds.reshape(-1, 2)
        scores_flat = scores.reshape(-1, k)
        props: List[dict] = []
        for cl in range(1, self.num_classes):
            mask = scores_flat[:, cl] > self.conf_thresh
            if not mask.any():
                continue
            block = np.concatenate(
                [seconds_flat[mask], scores_flat[mask, cl][:, None]], 1)
            kept, _ = soft_nms_numpy(block, sigma=self.nms_sigma,
                                     top_k=self.top_k)
            for row in kept:
                if row[2] <= 0:
                    continue
                props.append({'label': self.idx_to_class[cl],
                              'score': float(row[2]),
                              'segment': [float(row[0]), float(row[1])],
                              'uncertainty': 0.0, 'actionness': 0.0})
        return props


def _write(payload: dict, path: str) -> str:
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    with open(path, 'w') as f:
        json.dump(payload, f)
    return path


def run_openmax_test(cfg: Config, mav_dist_dir: str, tailsize: int = 20,
                     max_videos: Optional[int] = None,
                     device: Device = None) -> str:
    """Stages 2 and 3 over the THUMOS test videos; returns the JSON
    path."""
    te = cfg.testing
    om = OpenMaxInference(cfg, mav_dist_dir, tailsize, device=device)
    infos = get_video_info(cfg.get_path('dataset.testing.video_info_path'))
    npy = cfg.get_path('dataset.testing.video_data_path')
    result_dict: Dict[str, List[dict]] = {}
    for name in list(infos)[:max_videos]:
        info = infos[name]
        data = np.load(os.path.join(npy, name + '.npy'))
        result_dict[name] = om.run_video(data, info['sample_count'],
                                         info['sample_fps'])
    return _write({'version': 'THUMOS14', 'results': result_dict,
                   'external_data': {}},
                  os.path.join(te.get('output_path', './output'),
                               te.get('output_json',
                                      'detection_results.json')))


def run_openmax_cross_data(cfg: Config, mav_dist_dir: str,
                           anet_video_info: str, anet_npy_dir: str,
                           overlapping_class_file: str,
                           tailsize: int = 20,
                           max_videos: Optional[int] = None,
                           device: Device = None) -> str:
    """OpenMax over the ActivityNet unknowns merged with the THUMOS
    results (reference test_openmax_cross_data.py)."""
    te = cfg.testing
    with open(run_openmax_test(cfg, mav_dist_dir, tailsize, max_videos,
                               device)) as f:
        thumos_out = json.load(f)
    om = OpenMaxInference(cfg, mav_dist_dir, tailsize, device=device)
    infos = get_anet_video_info(anet_video_info, 'validation')
    names = [n for n in infos
             if os.path.exists(os.path.join(anet_npy_dir, n + '.npy'))]
    results: Dict[str, List[dict]] = {}
    for name in names[:max_videos]:
        # the reference pads short ANet videos to 768 frames with 127.5,
        # which normalizes to exactly 0: the raw uint8 frames with the
        # padded sample_count give the same windows (the pad as zeros
        # beyond frames-valid), with no uint8 truncation of 127.5
        data = np.load(os.path.join(anet_npy_dir, name + '.npy'))
        key = name[2:] if name.startswith('v_') else name
        results[key] = om.run_video(data, max(data.shape[0], 768),
                                    infos[name]['fps'])
    merged = dict(thumos_out['results'])
    merged.update(exclude_overlapping(results, infos,
                                      overlapping_class_file))
    return _write({'version': 'THUMOS14', 'results': merged,
                   'external_data': {}},
                  os.path.join(te.get('output_path', './output'),
                               'thumos14_anet_merged.json'))


def main(argv=None) -> None:
    parser = build_arg_parser()
    parser.add_argument('--cross_data', action='store_true')
    parser.add_argument('--anet_video_info', type=str, default=
                        'datasets/activitynet/annotations/'
                        'video_info_train_val.json')
    parser.add_argument('--anet_npy_dir', type=str,
                        default='datasets/activitynet/train_val_npy_112')
    parser.add_argument('--overlapping_class_file', type=str, default=
                        'datasets/activitynet/'
                        'overlapping_classes_in_thumos.txt')
    parser.add_argument('--device', type=str, default='cuda',
                        help='cuda (default) or cpu')
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    cfg = config_from_namespace(args)
    mav_dist_dir = os.path.join(cfg.testing.get('output_path', './output'),
                                'mav_dist')
    # stage idempotence as in test_openmax.py:407-414
    _, idx_to_class = get_class_index_map(
        cfg.get_path('dataset.class_info_path'))
    if not all(os.path.exists(os.path.join(mav_dist_dir, f'{n}.npz'))
               for n in idx_to_class.values()):
        compute_mav_dist(cfg, mav_dist_dir, device=device)
    if args.cross_data:
        path = run_openmax_cross_data(
            cfg, mav_dist_dir, args.anet_video_info, args.anet_npy_dir,
            args.overlapping_class_file, device=device)
    else:
        path = run_openmax_test(cfg, mav_dist_dir, device=device)
    print('wrote', path)


if __name__ == '__main__':
    main()
