"""Multi-split evaluation CLI: python -m opental_torch.tools.eval_open
<pred.json> [gt.json] [flags].

Copy of `opental_tpu/tools/eval_open.py`, on the port's evaluator.
Command-surface parity with `python AFSD/thumos14/eval_open.py`
(AFSD/thumos14/eval_open.py:9-143): loops open splits, computes closed
mAP or open FAR@95/AUC-ROC/AUC-PR/OSDR, writes eval(.open).txt next to
each prediction file, prints mean +- 1.96/sqrt(n) * std across splits.
"""

from __future__ import annotations

import argparse
import os
from typing import List

import numpy as np

from opental_torch.eval.detection import DetectionEvaluator


def get_mean_std(data, axis=0):
    arr = np.array(data)
    return arr.mean(axis=axis), arr.std(axis=axis) / np.sqrt(len(data)) * 1.96


def write_eval_open(eval_file, tious, far_95, auc_roc, auc_pr, osdr):
    with open(eval_file, 'w') as f:
        for tiou, far, roc, pr, od in zip(tious, far_95, auc_roc, auc_pr,
                                          osdr):
            f.write(f"tIoU={tiou}: far@95={far:.5f}, auc_roc={roc:.5f}, "
                    f"auc_pr={pr:.5f}, osdr={od:.5f}\n")
        f.write(f"Average FAR@95: {far_95.mean():.5f}, "
                f"Average AUC_ROC: {auc_roc.mean():.5f}, "
                f"Average AUC_PR: {auc_pr.mean():.5f}, "
                f"Average OSDR: {osdr.mean():.5f}\n")


def write_eval_closed(eval_file, tious, maps, average_map):
    with open(eval_file, 'w') as f:
        for tiou, m in zip(tious, maps):
            f.write(f"tIoU={tiou}: mAP={m:.5f}\n")
        f.write(f"Average mAP: {average_map:.5f}\n")


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument('output_json', type=str)
    p.add_argument('gt_json', type=str, nargs='?',
                   default='datasets/thumos14/annotations/thumos_gt.json')
    p.add_argument('--cls_idx_known', type=str)
    p.add_argument('--all_splits', nargs='+', type=int, default=[0])
    p.add_argument('--open_set', action='store_true')
    p.add_argument('--draw_auc', action='store_true',
                   help='dump ROC/PR/OSDR curve pickles + PNGs per split')
    p.add_argument('--wi', action='store_true',
                   help='also compute Wilderness Impact')
    p.add_argument('--dataset', type=str, default='thumos14',
                   choices=['thumos14', 'thumos_anet', 'anet'])
    p.add_argument('--ood_scoring', type=str, default='confidence',
                   choices=['uncertainty', 'confidence',
                            'uncertainty_actionness', 'a_by_inv_u',
                            'u_by_inv_a', 'half_au'])
    args = p.parse_args(argv)

    if args.dataset == 'thumos_anet':
        tious = np.linspace(0.5, 0.95, 10)
        subset = ['test', 'validation']
    elif args.dataset == 'anet':
        tious = np.asarray([0.1, 0.2, 0.3, 0.4, 0.5])
        subset = ['validation']
    else:
        tious = np.asarray([0.3, 0.4, 0.5, 0.6, 0.7])
        subset = ['test']

    maps_all: List[np.ndarray] = []
    avg_map_all: List[float] = []
    open_all = {'far': [], 'roc': [], 'pr': [], 'osdr': []}
    for split in args.all_splits:
        gt_file = (args.gt_json if args.open_set
                   else args.gt_json.format(id=split))
        pred_file = args.output_json.format(id=split)
        cls_idx = args.cls_idx_known.format(id=split)
        ev = DetectionEvaluator(gt_file, pred_file,
                                cls_idx_detection=cls_idx,
                                tiou_thresholds=tious,
                                ood_scoring=args.ood_scoring,
                                subset=subset, openset=args.open_set,
                                dataset='thumos14'
                                if args.dataset != 'anet' else 'anet')
        if args.open_set:
            print(f'Parsing results of split {split}...')
            ev.pre_evaluate()
            auc_roc, auc_pr, far_95 = ev.evaluate('AUC')
            osdr = ev.evaluate('OSDR')
            if args.draw_auc:
                from opental_torch.eval.curves import (
                    collect_roc_pr_curves, save_curve_data)
                scores, _, gts = ev.eval_data
                curves = collect_roc_pr_curves(scores, gts, tious)
                save_curve_data(curves['roc'], curves['pr'],
                                os.path.join(os.path.dirname(pred_file),
                                             'auc_data'), vis=True)
            if args.wi:
                m_wi, avg_wi, _ = ev.evaluate('WI')
                print(f'split {split}: mean WI per tIoU = '
                      f'{np.round(m_wi, 5)}, average mWI = {avg_wi:.5f}')
            open_all['far'].append(far_95)
            open_all['roc'].append(auc_roc)
            open_all['pr'].append(auc_pr)
            open_all['osdr'].append(osdr)
            write_eval_open(os.path.join(os.path.dirname(pred_file),
                                         'eval_open.txt'),
                            tious, far_95, auc_roc, auc_pr, osdr)
        else:
            maps, avg_map, _ = ev.evaluate('AP')
            maps_all.append(maps)
            avg_map_all.append(avg_map)
            write_eval_closed(os.path.join(os.path.dirname(pred_file),
                                           'eval.txt'),
                              tious, maps, avg_map)

    if args.open_set:
        for name, label in (('far', 'FAR@95'), ('roc', 'AUC_ROC'),
                            ('pr', 'AUC_PR'), ('osdr', 'OSDR')):
            mean, std = get_mean_std(open_all[name])
            for tiou, m, s in zip(tious, mean, std):
                print(f"{label}(tIoU={tiou}): mean={m:.5f}, std={s:.5f}")
            avg_mean, avg_std = get_mean_std(
                [a.mean() for a in open_all[name]])
            print(f"Average {label} = {avg_mean:.5f} ({avg_std:.5f})\n")
    else:
        mean, std = get_mean_std(maps_all)
        for tiou, m, s in zip(tious, mean, std):
            print(f"mAP(tIoU={tiou}): mean={m:.5f}, std={s:.5f}")
        avg_mean, avg_std = get_mean_std(avg_map_all)
        print(f"Average mAP is {avg_mean:.5f} ({avg_std:.5f})\n")


if __name__ == '__main__':
    main()
