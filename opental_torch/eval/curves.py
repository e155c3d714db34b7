"""Curve data capture + plots for open-set evaluation.

Copy of `opental_tpu/eval/curves.py`, with the ROC / PR primitives from
`eval/metrics.py`. Reference: AFSD/evaluation/utils_eval.py:136-192
(ROC/PR/OSDR pickle dumps + PNG plots) and the draw_* analysis scripts
under experiments/.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np

LINE_STYLES = ['r-', 'c-', 'g-', 'b-', 'k']


def collect_roc_pr_curves(pred_scores, gt_labels,
                          tiou_thresholds) -> Dict[str, dict]:
    """ROC and PR curve points per tIoU from pre_evaluate buckets
    (eval_detection.py:466-489)."""
    from opental_torch.eval.metrics import (average_precision_score,
                                            precision_recall_curve,
                                            roc_auc_score, roc_curve)
    roc_data = {'fpr': [], 'tpr': [], 'auc': [], 'tiou': []}
    pr_data = {'recall': [], 'precision': [], 'auc': [], 'tiou': []}
    for tidx, tiou in enumerate(tiou_thresholds):
        preds = pred_scores[tidx]['known'] + pred_scores[tidx]['unknown']
        labels_cls = gt_labels[tidx]['known'] + gt_labels[tidx]['unknown']
        if not preds:
            continue
        labels = 1 - np.array(labels_cls).astype(bool).astype(int)
        fpr, tpr, _ = roc_curve(labels, preds, pos_label=1)
        roc_data['fpr'].append(fpr)
        roc_data['tpr'].append(tpr)
        roc_data['auc'].append(roc_auc_score(labels, preds)
                               if len(set(labels.tolist())) > 1 else 0.0)
        roc_data['tiou'].append(tiou)
        precision, recall, _ = precision_recall_curve(labels, preds,
                                                      pos_label=1)
        pr_data['precision'].append(precision)
        pr_data['recall'].append(recall)
        pr_data['auc'].append(average_precision_score(labels, preds))
        pr_data['tiou'].append(tiou)
    return {'roc': roc_data, 'pr': pr_data}


def save_curve_data(roc_data: dict, pr_data: dict, save_path: str,
                    vis: bool = False, fontsize: int = 18) -> None:
    """Pickle curve data; optionally render PNGs
    (utils_eval.py:136-170)."""
    os.makedirs(save_path, exist_ok=True)
    with open(os.path.join(save_path, 'roc_data.pkl'), 'wb') as f:
        pickle.dump(roc_data, f, pickle.HIGHEST_PROTOCOL)
    with open(os.path.join(save_path, 'pr_data.pkl'), 'wb') as f:
        pickle.dump(pr_data, f, pickle.HIGHEST_PROTOCOL)
    if vis:
        _plot_xy(roc_data['fpr'], roc_data['tpr'], roc_data['auc'],
                 roc_data['tiou'], 'False Positive Rate',
                 'True Positive Rate',
                 os.path.join(save_path, 'AUC_ROC.png'), fontsize)
        _plot_xy(pr_data['recall'], pr_data['precision'], pr_data['auc'],
                 pr_data['tiou'], 'Recall', 'Precision',
                 os.path.join(save_path, 'AUC_PR.png'), fontsize)


def save_curve_osdr_data(osdr_data: dict, save_path: str,
                         vis: bool = False, fontsize: int = 18) -> None:
    os.makedirs(save_path, exist_ok=True)
    with open(os.path.join(save_path, 'osdr_data.pkl'), 'wb') as f:
        pickle.dump(osdr_data, f, pickle.HIGHEST_PROTOCOL)
    if vis:
        xs = [np.asarray(f)[:-2] for f in osdr_data['fpr']]
        ys = [np.asarray(c)[:-2] for c in osdr_data['cdr']]
        _plot_xy(xs, ys, osdr_data['osdr'], osdr_data['tiou'],
                 'False Positive Rate', 'Correct Detection Rate',
                 os.path.join(save_path, 'AUC_OSDR.png'), fontsize)


def _plot_xy(xs: Sequence, ys: Sequence, aucs: Sequence,
             tious: Sequence, xlabel: str, ylabel: str, out_png: str,
             fontsize: int) -> None:
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    plt.figure(figsize=(8, 5))
    for i, (x, y, auc, tiou) in enumerate(zip(xs, ys, aucs, tious)):
        plt.plot(x, y, LINE_STYLES[i % len(LINE_STYLES)],
                 label=f'tIoU={tiou}, auc={auc * 100:.2f}%')
    plt.xlabel(xlabel, fontsize=fontsize)
    plt.ylabel(ylabel, fontsize=fontsize)
    plt.xticks(fontsize=fontsize)
    plt.yticks(fontsize=fontsize)
    plt.legend(fontsize=max(8, fontsize - 6))
    plt.tight_layout()
    plt.savefig(out_png)
    plt.close()
