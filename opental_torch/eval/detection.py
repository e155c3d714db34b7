"""Open-set temporal detection evaluator.

Copy of `opental_tpu/eval/detection.py` (numpy re-design of the
reference ANETdetection, AFSD/evaluation/eval_detection.py:26-728 and
utils_eval.py:20-133), with the same greedy matching and metrics:

* AP: VOC-interpolated, score-descending greedy with per-GT locks
* AUC-ROC / AUC-PR / FAR@95 over known-vs-unknown OOD scores
* OSDR: area under the CCR-vs-FPR curve
* WI: wilderness impact

Data lives in plain dict-of-arrays records (no pandas); the ROC / PR
primitives come from `eval/metrics.py`, numpy with scikit-learn's
semantics (the JAX package and the reference call scikit-learn).
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from opental_torch.eval.metrics import (average_precision_score,
                                        roc_auc_score, roc_curve)

Records = Dict[str, np.ndarray]

OOD_FORMULAS = ('uncertainty', 'confidence', 'uncertainty_actionness',
                'a_by_inv_u', 'u_by_inv_a', 'half_au')


def segment_iou(target: np.ndarray, candidates: np.ndarray) -> np.ndarray:
    """tIoU of one [s, e] segment vs (N, 2) candidates
    (utils_eval.py:32-58)."""
    tt1 = np.maximum(target[0], candidates[:, 0])
    tt2 = np.minimum(target[1], candidates[:, 1])
    inter = (tt2 - tt1).clip(0)
    union = ((candidates[:, 1] - candidates[:, 0])
             + (target[1] - target[0]) - inter)
    return inter.astype(float) / union


def interpolated_prec_rec(prec: np.ndarray, rec: np.ndarray) -> float:
    """VOC-2011 interpolated AP (utils_eval.py:20-29)."""
    mprec = np.concatenate([[0], prec, [0]])
    mrec = np.concatenate([[0], rec, [1]])
    mprec = np.maximum.accumulate(mprec[::-1])[::-1]
    idx = np.where(mrec[1:] != mrec[:-1])[0] + 1
    return float(np.sum((mrec[idx] - mrec[idx - 1]) * mprec[idx]))


def ood_score(result: dict, scoring: str) -> float:
    """Per-proposal OOD score formulas (eval_detection.py:181-202)."""
    u, a, s = (result.get('uncertainty', 0.0),
               result.get('actionness', 0.0), result['score'])
    if scoring == 'uncertainty':
        return u
    if scoring == 'confidence':
        return 1.0 - s
    if scoring == 'uncertainty_actionness':
        return u * a
    if scoring == 'a_by_inv_u':
        return a / (1.0 - u + 1e-6)
    if scoring == 'u_by_inv_a':
        return u / (1.0 - a + 1e-6)
    if scoring == 'half_au':
        return 0.5 * (a + 1.0) * u
    raise ValueError(scoring)


def load_class_index(class_info_path: str, openset: bool,
                     dataset: str = 'thumos14') -> Dict[str, int]:
    """Class name -> contiguous index (1..K); '__unknown__' -> 0 in the
    open set (eval_detection.py:87-99)."""
    index: Dict[str, int] = {}
    if openset:
        index['__unknown__'] = 0
    with open(class_info_path) as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    for i, line in enumerate(lines):
        parts = line.split()
        name = parts[1] if dataset in ('thumos14', 'thumos_anet') \
            else line.strip()
        index[name] = i + 1
    return index


class DetectionEvaluator:
    """Reference-parity detection evaluation over a prediction JSON."""

    def __init__(self, ground_truth_filename: str,
                 prediction_filename: str, cls_idx_detection: str,
                 tiou_thresholds: np.ndarray = np.linspace(0.5, 0.95, 10),
                 ood_threshold: Optional[float] = None,
                 ood_scoring: str = 'confidence',
                 subset: Sequence[str] = ('validation',),
                 openset: bool = False, dataset: str = 'thumos14',
                 verbose: bool = False):
        self.tiou_thresholds = np.asarray(tiou_thresholds, float)
        self.ood_threshold = ood_threshold
        self.ood_scoring = ood_scoring
        self.openset = openset
        self.dataset = dataset
        self.verbose = verbose
        self.activity_index = load_class_index(cls_idx_detection, openset,
                                               dataset)
        self.ground_truth, self.video_lst = self._import_ground_truth(
            ground_truth_filename, subset)
        self.prediction = self._import_prediction(prediction_filename)
        self.eval_data = None
        self.stats: dict = {}

    # ---------------------------------------------------------- imports
    def _import_ground_truth(self, path: str, subset: Sequence[str]
                             ) -> Tuple[Records, List[str]]:
        with open(path) as f:
            data = json.load(f)
        vids, starts, ends, labels = [], [], [], []
        for videoid, v in data['database'].items():
            if v['subset'] not in subset:
                continue
            for ann in v['annotations']:
                vids.append(videoid)
                starts.append(float(ann['segment'][0]))
                ends.append(float(ann['segment'][1]))
                if self.openset:
                    labels.append(self.activity_index.get(ann['label'], 0))
                else:
                    labels.append(self.activity_index[ann['label']])
        gt = {'video-id': np.asarray(vids),
              't-start': np.asarray(starts, float),
              't-end': np.asarray(ends, float),
              'label': np.asarray(labels, int)}
        return gt, vids

    def _import_prediction(self, path: str) -> Records:
        with open(path) as f:
            data = json.load(f)
        video_set = set(self.video_lst)
        vids, starts, ends, labels, scores, oods = [], [], [], [], [], []
        for videoid, results in data['results'].items():
            if videoid not in video_set:
                continue
            for r in results:
                if r['label'] not in self.activity_index:
                    continue
                score = ood_score(r, self.ood_scoring)
                if (self.openset and self.ood_threshold is not None
                        and score < self.ood_threshold):
                    label = self.activity_index['__unknown__']
                else:
                    label = self.activity_index[r['label']]
                vids.append(videoid)
                starts.append(float(r['segment'][0]))
                ends.append(float(r['segment'][1]))
                labels.append(label)
                scores.append(r['score'])
                oods.append(score)
        return {'video-id': np.asarray(vids),
                't-start': np.asarray(starts, float),
                't-end': np.asarray(ends, float),
                'label': np.asarray(labels, int),
                'score': np.asarray(scores, float),
                'ood_score': np.asarray(oods, float)}

    # ------------------------------------------------------- public API
    def pre_evaluate(self) -> None:
        self.eval_data = split_results_by_gt(
            self.prediction, self.ground_truth, sorted(set(self.video_lst)),
            self.tiou_thresholds)

    def evaluate(self, type: str = 'AP'):
        if type == 'AP':
            self.ap = self._compute_ap()
            self.mAP = self.ap.mean(axis=1)
            self.average_mAP = self.mAP.mean()
            return self.mAP, self.average_mAP, self.ap
        if type == 'AUC':
            assert self.eval_data is not None, 'call pre_evaluate() first'
            pred_scores, _, gt_labels = self.eval_data
            self.au_roc, self.au_pr, self.far_95 = compute_auc_scores(
                pred_scores, gt_labels, self.tiou_thresholds)
            return self.au_roc, self.au_pr, self.far_95
        if type == 'OSDR':
            assert self.eval_data is not None, 'call pre_evaluate() first'
            pred_scores, pred_labels, gt_labels = self.eval_data
            self.osdr = compute_osdr_scores(pred_scores, pred_labels,
                                            gt_labels,
                                            self.tiou_thresholds)
            return self.osdr
        if type == 'WI':
            assert self.openset, 'WI needs the open set'
            self.wi, self.stats = compute_wilderness_impact(
                self.ground_truth, self.prediction,
                sorted(set(self.video_lst)),
                {k: v for k, v in self.activity_index.items()
                 if k != '__unknown__'}, self.tiou_thresholds)
            self.mWI = self.wi.mean(axis=1)
            self.average_mWI = self.mWI.mean()
            return self.mWI, self.average_mWI, self.wi
        raise NotImplementedError(type)

    def _compute_ap(self) -> np.ndarray:
        ap = np.zeros((len(self.tiou_thresholds),
                       len(self.activity_index)))
        gt, pred = self.ground_truth, self.prediction
        for cidx in self.activity_index.values():
            gt_sel = _select(gt, gt['label'] == cidx)
            pred_sel = _select(pred, pred['label'] == cidx)
            ap[:, cidx - 1] = compute_average_precision_detection(
                gt_sel, pred_sel, self.tiou_thresholds)
        return ap


def _select(rec: Records, mask: np.ndarray) -> Records:
    return {k: v[mask] for k, v in rec.items()}


def _group_by_video(rec: Records) -> Dict[str, Records]:
    order = defaultdict(list)
    for i, v in enumerate(rec['video-id']):
        order[v].append(i)
    return {v: _select(rec, np.asarray(idx, int))
            for v, idx in order.items()}


def compute_average_precision_detection(
        ground_truth: Records, prediction: Records,
        tiou_thresholds: np.ndarray) -> np.ndarray:
    """Greedy VOC AP with per-GT locks (eval_detection.py:323-402)."""
    n_t = len(tiou_thresholds)
    ap = np.zeros(n_t)
    n_pred = len(prediction['score'])
    npos = float(len(ground_truth['video-id']))
    if n_pred == 0 or npos == 0:
        return ap

    order = np.argsort(prediction['score'])[::-1]
    pred = _select(prediction, order)
    gt_by_video: Dict[str, dict] = {}
    gbv = _group_by_video(ground_truth)
    offset = {}
    # global GT row ids for the lock table
    pos = 0
    for v, sub in gbv.items():
        n = len(sub['video-id'])
        offset[v] = np.arange(pos, pos + n)
        gt_by_video[v] = sub
        pos += n
    lock_gt = np.full((n_t, int(npos)), -1.0)
    tp = np.zeros((n_t, n_pred))
    fp = np.zeros((n_t, n_pred))

    for idx in range(n_pred):
        vid = pred['video-id'][idx]
        if vid not in gt_by_video:
            fp[:, idx] = 1
            continue
        this_gt = gt_by_video[vid]
        gt_rows = offset[vid]
        tiou = segment_iou(
            np.array([pred['t-start'][idx], pred['t-end'][idx]]),
            np.stack([this_gt['t-start'], this_gt['t-end']], 1))
        sorted_j = np.argsort(tiou)[::-1]
        for tidx, thr in enumerate(tiou_thresholds):
            assigned = False
            for j in sorted_j:
                if tiou[j] < thr:
                    fp[tidx, idx] = 1
                    assigned = True
                    break
                if lock_gt[tidx, gt_rows[j]] >= 0:
                    continue
                tp[tidx, idx] = 1
                lock_gt[tidx, gt_rows[j]] = idx
                assigned = True
                break
            if not assigned:
                fp[tidx, idx] = 1

    tp_cum = np.cumsum(tp, axis=1)
    fp_cum = np.cumsum(fp, axis=1)
    recall = tp_cum / npos
    precision = tp_cum / (tp_cum + fp_cum)
    for tidx in range(n_t):
        ap[tidx] = interpolated_prec_rec(precision[tidx], recall[tidx])
    return ap


def split_results_by_gt(prediction: Records, ground_truth: Records,
                        video_list: Sequence[str],
                        tiou_thresholds: np.ndarray):
    """Bucket every prediction into bg/known/unknown per tIoU by greedy
    matching (eval_detection.py:405-456)."""
    n_t = len(tiou_thresholds)
    pred_scores = [{'bg': [], 'known': [], 'unknown': []}
                   for _ in range(n_t)]
    pred_labels = [{'bg': [], 'known': [], 'unknown': []}
                   for _ in range(n_t)]
    gt_labels = [{'bg': [], 'known': [], 'unknown': []}
                 for _ in range(n_t)]
    gt_by_vid = _group_by_video(ground_truth)
    pred_by_vid = _group_by_video(prediction)
    for video in video_list:
        if video not in gt_by_vid or video not in pred_by_vid:
            continue
        gt = gt_by_vid[video]
        pr = pred_by_vid[video]
        n_gt = len(gt['video-id'])
        lock = np.full((n_t, n_gt), -1.0)
        gt_segs = np.stack([gt['t-start'], gt['t-end']], 1)
        for idx in range(len(pr['video-id'])):
            score = pr['ood_score'][idx]
            label_pred = pr['label'][idx]
            tiou = segment_iou(
                np.array([pr['t-start'][idx], pr['t-end'][idx]]), gt_segs)
            sorted_j = np.argsort(tiou)[::-1]
            for tidx, thr in enumerate(tiou_thresholds):
                for j in sorted_j:
                    if tiou[j] < thr:
                        pred_scores[tidx]['bg'].append(score)
                        pred_labels[tidx]['bg'].append(label_pred)
                        gt_labels[tidx]['bg'].append(-1.0)
                        break
                    if lock[tidx, j] >= 0:
                        continue
                    bucket = 'unknown' if gt['label'][j] == 0 else 'known'
                    pred_scores[tidx][bucket].append(score)
                    pred_labels[tidx][bucket].append(label_pred)
                    gt_labels[tidx][bucket].append(int(gt['label'][j]))
                    lock[tidx, j] = idx
                    break
    return pred_scores, pred_labels, gt_labels


def compute_auc_scores(pred_scores, gt_labels, tiou_thresholds):
    """Known-vs-unknown AUC-ROC / AUC-PR / FAR@95
    (eval_detection.py:459-490)."""
    n_t = len(tiou_thresholds)
    auc_pr = np.zeros(n_t, np.float32)
    auc_roc = np.zeros(n_t, np.float32)
    far_95 = np.zeros(n_t, np.float32)
    for tidx in range(n_t):
        preds = pred_scores[tidx]['known'] + pred_scores[tidx]['unknown']
        labels_cls = gt_labels[tidx]['known'] + gt_labels[tidx]['unknown']
        labels = (1 - np.array(labels_cls).astype(bool).astype(int))
        if len(preds) > 0:
            auc_pr[tidx] = average_precision_score(labels, preds)
            auc_roc[tidx] = (roc_auc_score(labels, preds)
                             if len(set(labels.tolist())) > 1 else 0)
            fpr, tpr, _ = roc_curve(labels, preds, pos_label=1)
            far_95[tidx] = fpr[np.abs(tpr - 0.95).argmin()]
    return auc_roc, auc_pr, far_95


def open_set_detection_rate(preds: np.ndarray, pred_cls: np.ndarray,
                            gt_cls: np.ndarray):
    """Area under the CCR-vs-FPR curve (utils_eval.py:86-133), with the
    reference's O(n^2) cutoff loop replaced by suffix cumulative sums."""
    known = gt_cls > 0
    x1, x2 = preds[known], preds[~known]
    correct_known = np.zeros(len(x1))
    correct_known[pred_cls[known] == gt_cls[known]] = 1
    k_target = np.concatenate([correct_known, np.zeros(len(x2))])
    u_target = np.concatenate([np.zeros(len(x1)), np.ones(len(x2))])
    predict = np.concatenate([x1, x2])
    n = len(preds)

    idx = predict.argsort()
    s_k = k_target[idx]
    s_u = u_target[idx]
    # suffix sums: CC_k = sum(s_k[k+1:]), FP_k = sum(s_u[k:])
    suffix_k = np.concatenate([np.cumsum(s_k[::-1])[::-1], [0.0]])
    suffix_u = np.concatenate([np.cumsum(s_u[::-1])[::-1], [0.0]])
    ccr = np.zeros(n + 2)
    fpr = np.zeros(n + 2)
    ks = np.arange(n - 1)
    ccr[:n - 1] = (suffix_k[ks + 1] / len(x1)) if len(x1) > 0 else 1.0
    fpr[:n - 1] = (suffix_u[ks] / len(x2)) if len(x2) > 0 else 0.0
    ccr[n], fpr[n] = 0.0, 0.0
    ccr[n + 1], fpr[n + 1] = 1.0, 1.0

    roc = sorted(zip(fpr.tolist(), ccr.tolist()), reverse=True)
    roc = np.asarray(roc)
    w = roc[:-1, 0] - roc[1:, 0]
    h = (roc[:-1, 1] + roc[1:, 1]) / 2.0
    return float(np.sum(h * w)), fpr.tolist(), ccr.tolist()


def compute_osdr_scores(pred_scores, pred_labels, gt_labels,
                        tiou_thresholds):
    """(eval_detection.py:494-510)."""
    n_t = len(tiou_thresholds)
    osdr = np.zeros(n_t, np.float32)
    for tidx in range(n_t):
        preds = 1 - np.array(pred_scores[tidx]['known']
                             + pred_scores[tidx]['unknown'])
        pred_cls = np.array(pred_labels[tidx]['known']
                            + pred_labels[tidx]['unknown'])
        gt_cls = np.array(gt_labels[tidx]['known']
                          + gt_labels[tidx]['unknown'])
        if len(preds) > 0:
            osdr[tidx], _, _ = open_set_detection_rate(preds, pred_cls,
                                                       gt_cls)
    return osdr


def compute_wilderness_impact(ground_truth: Records, prediction: Records,
                              video_list: Sequence[str],
                              known_classes: Dict[str, int],
                              tiou_thresholds: np.ndarray):
    """Wilderness impact (eval_detection.py:604-728).

    The returned stats dict also carries column-aligned per-prediction
    'scores', 'ood_scores' and 'max_tious' arrays like the reference's
    stats-producing variant (eval_detection.py:513-601
    compute_wilderness_impact1, whose pickle feeds
    experiments/analyze_stats.py) — except that here the TP/FP category
    marks come from the same sorted-IoU + lock-fallback matcher that
    produces the parity-tested WI values, not v1's argmax-GT-only
    matcher."""
    n_t = len(tiou_thresholds)
    n_k = len(known_classes)
    n_pred = len(prediction['video-id'])
    wi = np.zeros((n_t, n_k))
    scores = np.zeros(n_pred)
    oods = np.zeros(n_pred)
    max_tious = np.zeros(n_pred)
    tp_u2u = np.zeros((n_t, n_pred))
    tp_k2k = np.zeros((n_t, n_k, n_pred))
    fp_u2k = np.zeros((n_t, n_k, n_pred))
    fp_k2k = np.zeros((n_t, n_k, n_pred))
    fp_k2u = np.zeros((n_t, n_pred))
    fp_bg2u = np.zeros((n_t, n_pred))
    fp_bg2k = np.zeros((n_t, n_k, n_pred))
    num_gt = np.zeros(n_k + 1, np.float32)

    gt_by_vid = _group_by_video(ground_truth)
    pred_by_vid = _group_by_video(prediction)
    vidx_offset = 0
    for video in video_list:
        gt = gt_by_vid.get(video)
        if gt is None:
            continue
        for lbl in gt['label']:
            num_gt[lbl] += 1
        pr = pred_by_vid.get(video)
        if pr is None:
            continue
        n_gt = len(gt['video-id'])
        gt_segs = np.stack([gt['t-start'], gt['t-end']], 1)
        lock = np.full((n_t, n_gt), -1.0)
        n_pr = len(pr['video-id'])
        scores[vidx_offset:vidx_offset + n_pr] = pr['score']
        oods[vidx_offset:vidx_offset + n_pr] = pr['ood_score']
        for idx in range(len(pr['video-id'])):
            tiou = segment_iou(
                np.array([pr['t-start'][idx], pr['t-end'][idx]]), gt_segs)
            max_tious[vidx_offset + idx] = tiou.max() if n_gt else 0.0
            sorted_j = np.argsort(tiou)[::-1]
            label_pred = int(pr['label'][idx])
            col = vidx_offset + idx
            for tidx, thr in enumerate(tiou_thresholds):
                for j in sorted_j:
                    if tiou[j] < thr:
                        if label_pred == 0:
                            fp_bg2u[tidx, col] = 1
                        else:
                            fp_bg2k[tidx, label_pred - 1, col] = 1
                        break
                    if lock[tidx, j] >= 0:
                        continue
                    label_gt = int(gt['label'][j])
                    if label_pred == label_gt:
                        if label_gt == 0:
                            tp_u2u[tidx, col] = 1
                        else:
                            tp_k2k[tidx, label_pred - 1, col] = 1
                        lock[tidx, j] = idx
                    else:
                        if label_gt == 0:
                            fp_u2k[tidx, label_pred - 1, col] = 1
                        elif label_pred == 0:
                            fp_k2u[tidx, col] = 1
                        else:
                            fp_k2k[tidx, label_pred - 1, col] = 1
                    break
        vidx_offset += len(pr['video-id'])

    stats = {'tp_k2k': tp_k2k, 'tp_u2u': tp_u2u, 'fp_k2k': fp_k2k,
             'fp_k2u': fp_k2u, 'fp_u2k': fp_u2k, 'fp_bg2k': fp_bg2k,
             'fp_bg2u': fp_bg2u, 'num_gt': num_gt, 'scores': scores,
             'ood_scores': oods, 'max_tious': max_tious}

    fp_k2u = fp_k2u + fp_bg2u
    fp_k2k = fp_k2k + fp_bg2k
    tp_u2u_cum = np.cumsum(tp_u2u, axis=-1)
    recall_ratio = num_gt[1:].sum() / (num_gt[1:].sum() + num_gt[0]
                                       - tp_u2u_cum)
    tp_k2k_cum = np.cumsum(tp_k2k, axis=-1)
    fp_u2k_cum = np.cumsum(fp_u2k, axis=-1)
    fp_k2k_cum = np.cumsum(fp_k2k, axis=-1)
    precision_ratio = (tp_k2k_cum + fp_k2k_cum) / (
        tp_k2k_cum + fp_k2k_cum + fp_u2k_cum + 1e-6)
    for tidx in range(n_t):
        for cidx in range(n_k):
            wi[tidx, cidx] = interpolated_prec_rec(
                precision_ratio[tidx, cidx], recall_ratio[tidx])
    return wi, stats
