"""OOD score threshold calibration (95% TPR on the training set).

Counterpart of `opental_tpu/openset/threshold.py` (THUMOS: reference
AFSD/thumos14/threshold.py:71-170; ActivityNet: AFSD/anet/threshold.py:
31-63): run inference over the TRAINING videos, compose a
confidence-style score per proposal (the inverse orientation of the
evaluator's ood_score), and take the score at the 95%-TPR percentile as
the deployment rejection threshold, stored in the detection JSON's
external_data.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from opental_torch.config import Config
from opental_torch.data.thumos import get_class_index_map, get_video_info
from opental_torch.infer.pipeline import (InferencePipeline, infer_videos,
                                          proposals_to_json)
from opental_torch.tools.test_anet import run_test_anet


def confidence_score(prop: Dict[str, Any], scoring: str) -> float:
    """Known-class confidence formulas (threshold.py:130-143); these are
    1 - ood_score of the evaluator's formulas."""
    u, a, s = prop['uncertainty'], prop['actionness'], prop['score']
    if scoring == 'uncertainty':
        return 1.0 - u
    if scoring == 'confidence':
        return s
    if scoring == 'uncertainty_actionness':
        return 1.0 - u * a
    if scoring == 'a_by_inv_u':
        return 1.0 - a / (1.0 - u + 1e-6)
    if scoring == 'u_by_inv_a':
        return 1.0 - u / (1.0 - a + 1e-6)
    if scoring == 'half_au':
        return 1.0 - 0.5 * (a + 1.0) * u
    raise ValueError(scoring)


def threshold_from_results(result_dict: Dict[str, List[dict]],
                           scoring: str, tpr: float = 0.95) -> float:
    """Score at the (1 - tpr) quantile (threshold.py:145-148)."""
    scores = [confidence_score(p, scoring)
              for props in result_dict.values() for p in props]
    if not scores:
        raise ValueError(
            'threshold calibration produced zero proposals across '
            f'{len(result_dict)} videos: check the checkpoint, '
            'conf_thresh, and that the training npys exist')
    score_sorted = np.sort(scores)
    n = len(scores)
    top_k = n - int(n * tpr)
    return float(score_sorted[top_k - 1])


def output_file(cfg: Config) -> str:
    te = cfg.testing
    return os.path.join(te.get('output_path', './output'),
                        te.get('output_json', 'thresholding.json'))


def read_threshold(path: str) -> float:
    with open(path) as f:
        return float(json.load(f)['external_data']['threshold'])


def calibrate_anet(cfg: Config, max_videos: Optional[int] = None,
                   binary: bool = False,
                   cls_score_file: Optional[str] = None,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> float:
    """ANet calibration (`opental_tpu/openset/threshold.py:58-100`): run
    `tools.test_anet.run_test_anet` over the TRAINING subset (restricted
    to the videos of the classifier file where one is given,
    anet/threshold.py:35-38), take the score at the 95%-TPR percentile
    and store it in the detection JSON's external_data. An existing
    output file is read back, not recomputed."""
    path = output_file(cfg)
    if os.path.exists(path):
        return read_threshold(path)
    train_cfg = cfg.clone()
    train_cfg['testing']['output_json'] = os.path.basename(path)
    tr = cfg.get_path('dataset.training', {})
    for key in ('video_info_path', 'video_mp4_path', 'video_data_path'):
        if key in tr:
            train_cfg['dataset']['testing'][key] = tr[key]
    video_names = None
    if cls_score_file:
        with open(cls_score_file) as f:
            cls_vids = json.load(f)['results']
        video_names = {'v_' + n for n in cls_vids} | set(cls_vids)
    out_path = run_test_anet(train_cfg, max_videos=max_videos,
                             binary=binary, cls_score_file=cls_score_file,
                             subset='training', video_names=video_names,
                             device=device)
    with open(out_path) as f:
        payload = json.load(f)
    threshold = threshold_from_results(
        payload['results'], cfg.testing.get('ood_scoring', 'confidence'))
    payload['external_data']['threshold'] = threshold
    with open(out_path, 'w') as f:
        json.dump(payload, f)
    return threshold


def calibrate(cfg: Config, pipeline: InferencePipeline,
              max_videos: Optional[int] = None) -> float:
    """Run train-set inference with `pipeline` and write the
    threshold-carrying JSON; returns the threshold (read back from that
    JSON where it exists). With a flow model both streams are read from
    the training-section paths `training.rgb_data_path` and
    `training.flow_data_path`, as the reference does (threshold.py:40-44,
    :75)."""
    te = cfg.testing
    path = output_file(cfg)
    if os.path.exists(path):
        return read_threshold(path)
    video_infos = get_video_info(
        cfg.get_path('dataset.training.video_info_path'))
    _, idx_to_class = get_class_index_map(
        cfg.get_path('dataset.class_info_path'))
    fusion = pipeline.flow_model is not None
    npy_path = (cfg.get_path('training.rgb_data_path',
                             './datasets/thumos14/validation_npy/')
                if fusion
                else cfg.get_path('dataset.training.video_data_path'))
    flow_path = cfg.get_path('training.flow_data_path',
                             './datasets/thumos14/validation_flow_npy/')
    names = list(video_infos)[:max_videos]
    result_dict = infer_videos(pipeline, te, video_infos, names,
                               npy_path, flow_path)
    threshold = threshold_from_results(
        result_dict, te.get('ood_scoring', 'confidence'))
    proposals_to_json(result_dict, idx_to_class,
                      te.get('output_path', './output'),
                      te.get('output_json', 'thresholding.json'),
                      external_data={'threshold': threshold})
    return threshold
