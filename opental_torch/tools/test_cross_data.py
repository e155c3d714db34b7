"""Cross-dataset open-set test: python -m opental_torch.tools.test_cross_data
<cfg.yaml> [flags] [--anet_video_info ...] [--anet_npy_dir ...]
[--overlapping_class_file ...] [--device cuda|cpu].

Counterpart of `opental_tpu/tools/test_cross_data.py` (reference
AFSD/thumos14/test_cross_data.py): the THUMOS-trained model runs (a) over
the THUMOS14 test videos and (b) over the ActivityNet validation videos
(768-frame npys padded with 127.5, windowed with the THUMOS clip and
stride); ANet videos holding a THUMOS-overlapping class are dropped
(:333-351) and both result sets merge into
`thumos14_anet_merged.json` (:412-446). Both passes run through the
config's pipeline (`tools.test.build_pipeline`, packed by default); an
existing per-pass JSON is read back instead of recomputed. Runs on the
card unless `--device cpu` (or device='cpu') is asked for.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Dict, Optional, Union

import numpy as np
import torch

from opental_torch.config import (Config, build_arg_parser,
                                  config_from_namespace)
from opental_torch.data.anet import get_video_info as get_anet_video_info
from opental_torch.data.prefetch import prefetch_items
from opental_torch.infer.pipeline import (infer_videos, packed_frames,
                                          proposals_to_json)
from opental_torch.tools.test import build_pipeline


def exclude_overlapping(results: Dict[str, list],
                        anet_video_infos: Dict[str, dict],
                        overlapping_class_file: str) -> Dict[str, list]:
    """Drop the ANet videos annotated with a THUMOS-overlapping class
    (test_cross_data.py:333-351)."""
    with open(overlapping_class_file) as f:
        excluded = {ln.strip() for ln in f.read().splitlines()
                    if ln.strip()}
    kept = {}
    for video_name, preds in results.items():
        info = anet_video_infos.get('v_' + video_name,
                                    anet_video_infos.get(video_name, {}))
        if any(a['label'] in excluded
               for a in info.get('annotations', [])):
            continue
        kept[video_name] = preds
    return kept


def _read(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def run_cross_data(cfg: Config, anet_video_info: str, anet_npy_dir: str,
                   overlapping_class_file: str,
                   max_videos: Optional[int] = None,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> str:
    """Both passes and the merge; returns the merged JSON's path."""
    te = cfg.testing
    pipe, thumos_infos, idx_to_class = build_pipeline(cfg, device)
    out_path = te.get('output_path', './output')
    os.makedirs(out_path, exist_ok=True)

    # pass 1: the THUMOS14 test set (reference :412-418)
    thumos_file = os.path.join(out_path, 'thumos14_open_rgb.json')
    if not os.path.exists(thumos_file):
        npy = cfg.get_path('dataset.testing.video_data_path')
        results = infer_videos(pipe, te, thumos_infos,
                               list(thumos_infos)[:max_videos], npy, '')
        proposals_to_json(results, idx_to_class, out_path,
                          'thumos14_open_rgb.json')
    thumos_out = _read(thumos_file)

    # pass 2: the ANet validation videos through the same windows
    anet_infos = get_anet_video_info(anet_video_info, 'validation')
    anet_file = os.path.join(out_path, 'anet_open_rgb.json')
    if not os.path.exists(anet_file):
        names = [n for n in anet_infos
                 if os.path.exists(os.path.join(anet_npy_dir, n + '.npy'))]

        def raw_item(n):
            # the reference pads short ANet videos to 768 frames with
            # 127.5 (test_cross_data.py:80-89), which normalizes to
            # exactly 0, the value every window path fills beyond the
            # real frames: the raw uint8 frames with the padded
            # sample_count give the same windows
            data = np.load(os.path.join(anet_npy_dir, n + '.npy'))
            key = n[2:] if n.startswith('v_') else n
            return key, data, max(data.shape[0], 768), anet_infos[n]['fps']

        with contextlib.closing(prefetch_items(names[:max_videos],
                                               raw_item)) as videos:
            if te.get('packed', True):
                results = pipe.run_videos(
                    videos, max_batch=te.get('packed_batch', 128),
                    frames_capacity=packed_frames(te))
            else:
                results = {key: pipe.run_video(data, sample_count=sc,
                                               sample_fps=fps)
                           for key, data, sc, fps in videos}
        proposals_to_json(results, idx_to_class, out_path,
                          'anet_open_rgb.json')
    anet_out = _read(anet_file)

    merged = dict(thumos_out['results'])
    merged.update(exclude_overlapping(anet_out['results'], anet_infos,
                                      overlapping_class_file))
    merged_path = os.path.join(out_path, te.get(
        'output_json', 'thumos14_anet_merged.json'))
    with open(merged_path, 'w') as f:
        json.dump({'version': 'THUMOS14', 'results': merged,
                   'external_data': {}}, f)
    return merged_path


def main(argv=None) -> None:
    parser = build_arg_parser()
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
    print('wrote', run_cross_data(config_from_namespace(args),
                                  args.anet_video_info, args.anet_npy_dir,
                                  args.overlapping_class_file,
                                  device=args.device))


if __name__ == '__main__':
    main()
