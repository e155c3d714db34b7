"""Analysis + comparison plots over detection results and train logs.

Compact port of the reference analysis suite (experiments/
analyze_actionness.py, analyze_gradnorm.py, analyze_stats.py,
draw_auc_comparison.py, draw_oodbar_comparison.py,
AFSD/thumos14/draw_distribution.py): per-bucket score/uncertainty/
actionness distributions of greedily-matched predictions, grad-norm
curves from the JSONL train log, and multi-method ROC/PR/OSDR overlays
from the evaluator's pickled curve data.

Usage (library or CLI):
  python -m opental_torch.tools.analysis scores <pred.json> <gt.json> \
      --cls_idx <Class_Index_Known.txt> --out dist.png
  python -m opental_torch.tools.analysis gradnorm <metrics.jsonl> --out g.png
  python -m opental_torch.tools.analysis compare_auc <name=roc_data.pkl> ...
  python -m opental_torch.tools.analysis distribution <cfg.yaml> \
      --gt_json gt.json --cls_idx <Class_Index_Known.txt> [--device cpu]

Copy of `opental_tpu/tools/analysis.py` on the port's evaluator. The
three commands that run the network (distribution, actionness,
per_class) fill the raw-output cache through the port's
`search_param.cache_raw_outputs` on the card unless `--device cpu` is
asked for; every other command reads files only.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np


def _plt():
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    return plt


def bucket_distributions(pred_json: str, gt_json: str, cls_idx: str,
                         ood_scoring: str = 'uncertainty',
                         tiou: float = 0.3) -> Dict[str, Dict[str, list]]:
    """Bucket predictions into bg/known/unknown via the evaluator's
    greedy matcher and collect their score fields
    (analyze_actionness.py semantics)."""
    from opental_torch.eval.detection import (DetectionEvaluator,
                                              split_results_by_gt)
    ev = DetectionEvaluator(gt_json, pred_json, cls_idx,
                            tiou_thresholds=np.asarray([tiou]),
                            ood_scoring=ood_scoring, subset=['test'],
                            openset=True)
    scores, labels, gts = split_results_by_gt(
        ev.prediction, ev.ground_truth, sorted(set(ev.video_lst)),
        np.asarray([tiou]))
    return {'ood_score': scores[0], 'pred_label': labels[0],
            'gt_label': gts[0]}


def plot_score_distributions(buckets: Dict[str, Dict[str, list]],
                             out_png: str, bins: int = 40) -> None:
    plt = _plt()
    plt.figure(figsize=(8, 5))
    colors = {'known': 'g', 'unknown': 'r', 'bg': 'gray'}
    for name, color in colors.items():
        vals = np.asarray(buckets['ood_score'][name], float)
        if len(vals):
            plt.hist(vals, bins=bins, alpha=0.5, density=True,
                     color=color, label=f'{name} (n={len(vals)})')
    plt.xlabel('OOD score')
    plt.ylabel('density')
    plt.legend()
    plt.tight_layout()
    plt.savefig(out_png)
    plt.close()


def _known_names(cls_idx: str) -> List[str]:
    with open(cls_idx) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    parts = [ln.split() for ln in lines]
    return [p[1] if len(p) > 1 else p[0] for p in parts]


def _gt_segments(gt_json: str, cls_idx: str) -> Dict[str, Dict[str, list]]:
    """Per-video known/unknown GT segments in seconds from the open GT
    JSON (draw_distribution.py:421-446)."""
    known = set(_known_names(cls_idx))
    with open(gt_json) as f:
        database = json.load(f)['database']
    out: Dict[str, Dict[str, list]] = {}
    for vid, entry in database.items():
        segs = {'known': [], 'unknown': []}
        for ann in entry.get('annotations', []):
            key = 'known' if ann['label'] in known else 'unknown'
            segs[key].append((float(ann['segment'][0]),
                              float(ann['segment'][1])))
        out[vid] = segs
    return out


def _dirichlet_prob(logits: np.ndarray) -> np.ndarray:
    alpha = np.exp(np.clip(logits, -10.0, 10.0)) + 1.0
    return alpha / alpha.sum(-1, keepdims=True)


def _softmax(logits: np.ndarray) -> np.ndarray:
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def _sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))


def _stage_values(z, w: int, stage: str, target: str,
                  use_edl: bool = True) -> np.ndarray:
    """Per-prior target values for one window at one stage
    (draw_distribution.py get_result :325-349,
    analyze_actionness.py:266-295)."""
    unct = z['unct'][w] if 'unct' in z.files else None
    act_key = 'act' if stage == 'coarse' else 'prop_act'
    act = (_sigmoid(z[act_key][w, :, 0]) if act_key in z.files else None)
    if stage == 'refined' and unct is not None:
        unct = z['prop_unct'][w]
    if target == 'uncertainty':
        return unct
    if target == 'actionness':
        return act
    if target == 'uncertainty_actionness':
        return unct * act
    if target == 'half_au':
        return 0.5 * (act + 1.0) * unct
    if target == 'confidence':
        logits = z['conf'][w] if stage == 'coarse' else z['prop_conf'][w]
        probs = _dirichlet_prob(logits) if use_edl else _softmax(logits)
        conf = probs * _sigmoid(z['center'][w])
        if act is not None:
            conf = conf * act[:, None]
        return conf.max(-1)
    raise ValueError(target)


def stage_buckets(cfg, cache_dir: str, gt_json: str, cls_idx: str,
                  target: str = 'uncertainty', piou: float = 0.5,
                  max_videos: Optional[int] = None
                  ) -> Dict[str, Dict[str, np.ndarray]]:
    """Prior-level known/unknown/background bucketing at the coarse and
    refined stages over the raw-output cache.

    Reference semantics (draw_distribution.py:221-259 get_matched_targets
    + :323-389 split_results_by_stages): a prior is a known positive when
    its center lies inside a known-class GT segment; at the refined stage
    it additionally needs IoU(coarse-decoded segment, min-area enclosing
    GT) >= piou (demoted priors count as background). Priors inside
    unknown-class GT form the unknown bucket. Returns
    {stage: {known|unknown|background: 1-D values array}}.
    """
    from opental_torch.data.thumos import get_video_info

    video_infos = get_video_info(
        cfg.get_path('dataset.testing.video_info_path'))
    clip_length = cfg.get_path('dataset.testing.clip_length', 256)
    use_edl = cfg.get_path('model.use_edl', False)
    gt = _gt_segments(gt_json, cls_idx)

    out = {s: {b: [] for b in ('known', 'unknown', 'background')}
           for s in ('coarse', 'refined')}
    names = [n for n in list(video_infos)[:max_videos]
             if os.path.exists(os.path.join(cache_dir, n + '.npz'))]
    for name in names:
        z = np.load(os.path.join(cache_dir, name + '.npz'))
        fps = float(z['sample_fps'])
        centers = z['priors'][:, 0] * clip_length          # (P,) frames
        segs = gt.get(name, {'known': [], 'unknown': []})
        k_f = np.array([(s * fps, e * fps)
                        for s, e in segs['known']], np.float32
                       ).reshape(-1, 2)
        u_f = np.array([(s * fps, e * fps)
                        for s, e in segs['unknown']], np.float32
                       ).reshape(-1, 2)
        for w, off in enumerate(z['offsets']):
            abs_c = centers + off                          # (P,)

            def inside(seg):
                if not len(seg):
                    return np.zeros(abs_c.shape, bool)
                return ((abs_c[:, None] >= seg[None, :, 0])
                        & (abs_c[:, None] <= seg[None, :, 1])).any(1)

            known_m = inside(k_f)
            unknown_m = inside(u_f) & ~known_m
            bg_m = ~known_m & ~unknown_m

            vals_c = _stage_values(z, w, 'coarse', target, use_edl)
            vals_r = _stage_values(z, w, 'refined', target, use_edl)
            for m, b in ((known_m, 'known'), (unknown_m, 'unknown'),
                         (bg_m, 'background')):
                out['coarse'][b].append(vals_c[m])

            # refined: known demoted to background below the IoU gate
            # (prop_conf[iou < overlap_thresh] = 0,
            #  draw_distribution.py:251-253)
            ref_known = known_m.copy()
            if len(k_f) and known_m.any():
                left = abs_c[:, None] - k_f[None, :, 0]
                right = k_f[None, :, 1] - abs_c[:, None]
                area = left + right
                area = np.where((left < 0) | (right < 0), np.inf, area)
                best = area.argmin(1)
                gt_seg = k_f[best] - off                   # window coords
                loc = z['loc'][w]
                dec = np.stack([np.clip(centers - loc[:, 0], 0,
                                        clip_length),
                                np.clip(centers + loc[:, 1], 0,
                                        clip_length)], 1)
                inter = (np.minimum(dec[:, 1], gt_seg[:, 1])
                         - np.maximum(dec[:, 0], gt_seg[:, 0]))
                union = (dec[:, 1] - dec[:, 0]) \
                    + (gt_seg[:, 1] - gt_seg[:, 0]) - inter
                iou = np.where(union > 0, inter / np.maximum(union, 1e-6),
                               0.0)
                ref_known &= (iou >= piou) & (inter > 0)
            out['refined']['known'].append(vals_r[ref_known])
            out['refined']['unknown'].append(vals_r[unknown_m])
            out['refined']['background'].append(
                vals_r[~ref_known & ~unknown_m])

    return {s: {b: (np.concatenate(v) if v else np.zeros(0))
                for b, v in bs.items()} for s, bs in out.items()}


def plot_dist(out_png: str, arrays: Sequence[np.ndarray],
              colors: Sequence[str], labels: Sequence[str],
              xlabel: str = '', bins: int = 50) -> None:
    """Normalized overlaid histograms (draw_distribution.py
    plot_unct_dist :392-408)."""
    plt = _plt()
    plt.figure(figsize=(5, 4))
    for arr, color, label in zip(arrays, colors, labels):
        arr = np.asarray(arr, float)
        if len(arr):
            plt.hist(arr, bins=bins, alpha=0.5, density=True, color=color,
                     label=f'{label} (n={len(arr)})')
    plt.xlabel(xlabel, fontsize=12)
    plt.ylabel('density', fontsize=12)
    plt.legend(fontsize=10)
    plt.tight_layout()
    plt.savefig(out_png)
    plt.close()


def distribution_report(cfg, cache_dir: str, gt_json: str, cls_idx: str,
                        out_dir: str, target: str = 'uncertainty',
                        pred_json: Optional[str] = None) -> List[str]:
    """The draw_distribution.py figure set: per-stage prior-level
    distributions (dist_coarse/dist_refined, Known vs Unknown&Bg) plus
    final post-processed proposal distributions via greedy GT matching
    (dist_final / dist_final_nobg) when a detection JSON is given
    (:560-626)."""
    os.makedirs(out_dir, exist_ok=True)
    written = []
    stages = stage_buckets(cfg, cache_dir, gt_json, cls_idx, target)
    for stage in ('coarse', 'refined'):
        b = stages[stage]
        path = os.path.join(out_dir, f'dist_{stage}.png')
        plot_dist(path,
                  [b['known'],
                   np.concatenate([b['unknown'], b['background']])],
                  ['green', 'red'], ['Known', 'Unknown & Bg'],
                  xlabel=target)
        written.append(path)
    if pred_json:
        fin = bucket_distributions(pred_json, gt_json, cls_idx,
                                   ood_scoring=target
                                   if target != 'confidence'
                                   else 'confidence', tiou=0.5)
        k = np.asarray(fin['ood_score']['known'], float)
        u = np.asarray(fin['ood_score']['unknown'], float)
        bg = np.asarray(fin['ood_score']['bg'], float)
        path = os.path.join(out_dir, 'dist_final.png')
        plot_dist(path, [k, u, bg], ['green', 'red', 'blue'],
                  ['Known', 'Unknown', 'Background'], xlabel=target)
        written.append(path)
        path = os.path.join(out_dir, 'dist_final_nobg.png')
        plot_dist(path, [k, u], ['green', 'red'], ['Known', 'Unknown'],
                  xlabel=target)
        written.append(path)
    return written


def per_class_buckets(cfg, cache_dir: str, gt_json: str, cls_idx: str,
                      target: str = 'uncertainty',
                      max_videos: Optional[int] = None
                      ) -> Dict[str, Dict[str, np.ndarray]]:
    """Per-CLASS prior-level values at both stages: a known prior is
    attributed to the class of its (first) containing GT segment.
    Extends stage_buckets' known bucket with class identity (per-class
    per-stage depth of draw_distribution.py's figure families).
    Returns {stage: {class_name: values}}."""
    from opental_torch.data.thumos import get_video_info

    video_infos = get_video_info(
        cfg.get_path('dataset.testing.video_info_path'))
    clip_length = cfg.get_path('dataset.testing.clip_length', 256)
    use_edl = cfg.get_path('model.use_edl', False)
    known = _known_names(cls_idx)
    with open(gt_json) as f:
        database = json.load(f)['database']

    out = {s: {c: [] for c in known} for s in ('coarse', 'refined')}
    names = [n for n in list(video_infos)[:max_videos]
             if os.path.exists(os.path.join(cache_dir, n + '.npz'))]
    for name in names:
        segs_by_cls: Dict[str, list] = {}
        for ann in database.get(name, {}).get('annotations', []):
            if ann['label'] in out['coarse']:
                segs_by_cls.setdefault(ann['label'], []).append(
                    (float(ann['segment'][0]), float(ann['segment'][1])))
        if not segs_by_cls:
            continue
        z = np.load(os.path.join(cache_dir, name + '.npz'))
        fps = float(z['sample_fps'])
        centers = z['priors'][:, 0] * clip_length
        for w, off in enumerate(z['offsets']):
            abs_c = centers + off
            vals = {s: _stage_values(z, w, s, target, use_edl)
                    for s in ('coarse', 'refined')}
            for cls_name, segs in segs_by_cls.items():
                seg = np.array([(s * fps, e * fps) for s, e in segs],
                               np.float32).reshape(-1, 2)
                m = ((abs_c[:, None] >= seg[None, :, 0])
                     & (abs_c[:, None] <= seg[None, :, 1])).any(1)
                if m.any():
                    for s in ('coarse', 'refined'):
                        out[s][cls_name].append(vals[s][m])
    return {s: {c: (np.concatenate(v) if v else np.zeros(0))
                for c, v in cs.items()} for s, cs in out.items()}


def per_class_report(cfg, cache_dir: str, gt_json: str, cls_idx: str,
                     out_dir: str, target: str = 'uncertainty',
                     max_videos: Optional[int] = None) -> List[str]:
    """Per-class per-stage distribution grid
    (dist_<stage>_per_class.png: one histogram panel per known class)
    plus a machine-readable summary CSV (per_class_stats.csv: class,
    stage, count, mean, std, p05, p95)."""
    plt = _plt()
    os.makedirs(out_dir, exist_ok=True)
    buckets = per_class_buckets(cfg, cache_dir, gt_json, cls_idx,
                                target, max_videos)
    written = []
    for stage in ('coarse', 'refined'):
        classes = [c for c in buckets[stage] if len(buckets[stage][c])]
        if not classes:
            continue
        cols = min(4, len(classes))
        rows = (len(classes) + cols - 1) // cols
        fig, axes = plt.subplots(rows, cols,
                                 figsize=(3.2 * cols, 2.4 * rows),
                                 squeeze=False)
        for i, cls_name in enumerate(classes):
            ax = axes[i // cols][i % cols]
            v = buckets[stage][cls_name]
            ax.hist(v, bins=30, color='steelblue', density=True)
            ax.set_title(f'{cls_name} (n={len(v)})', fontsize=8)
        for j in range(len(classes), rows * cols):
            axes[j // cols][j % cols].axis('off')
        fig.suptitle(f'{target} per class — {stage} stage')
        fig.tight_layout()
        path = os.path.join(out_dir, f'dist_{stage}_per_class.png')
        fig.savefig(path)
        plt.close(fig)
        written.append(path)
    csv_path = os.path.join(out_dir, 'per_class_stats.csv')
    with open(csv_path, 'w') as f:
        f.write('class,stage,count,mean,std,p05,p95\n')
        for stage, cs in buckets.items():
            for cls_name, v in cs.items():
                if len(v):
                    f.write(f'{cls_name},{stage},{len(v)},{v.mean():.6f},'
                            f'{v.std():.6f},{np.percentile(v, 5):.6f},'
                            f'{np.percentile(v, 95):.6f}\n')
                else:
                    f.write(f'{cls_name},{stage},0,,,,\n')
    written.append(csv_path)
    return written


def actionness_report(cfg, cache_dir: str, gt_json: str, cls_idx: str,
                      out_dir: str) -> List[str]:
    """The analyze_actionness.py figure set (:362-426): 3-bucket
    actionness and uncertainty distributions at both stages, plus
    foreground-vs-background actionness and known-vs-unknown uncertainty
    views."""
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for target in ('actionness', 'uncertainty'):
        stages = stage_buckets(cfg, cache_dir, gt_json, cls_idx, target)
        for stage in ('coarse', 'refined'):
            b = stages[stage]
            path = os.path.join(out_dir, f'{target}_dist_{stage}.png')
            plot_dist(path, [b['known'], b['unknown'], b['background']],
                      ['green', 'red', 'cyan'],
                      ['Known', 'Unknown', 'Background'], xlabel=target)
            written.append(path)
            if target == 'actionness':
                fg = np.concatenate([b['known'], b['unknown']])
                path = os.path.join(out_dir, f'dist_{stage}_act.png')
                plot_dist(path, [fg, b['background']], ['red', 'blue'],
                          ['Foreground', 'Background'], xlabel=target)
            else:
                path = os.path.join(out_dir, f'dist_{stage}_unct.png')
                plot_dist(path, [b['known'], b['unknown']],
                          ['red', 'blue'],
                          ['Known Actions', 'Unknown Actions'],
                          xlabel=target)
            written.append(path)
    return written


def correctness_buckets(pred_json: str, gt_json: str, cls_idx: str,
                        ood_scoring: str = 'uncertainty',
                        tiou: float = 0.5) -> Dict[str, np.ndarray]:
    """Final-proposal ood scores split by classification correctness
    (draw_distribution.py split_uncertainties_correct :513-557): a
    known-matched proposal is 'correct' when its predicted label equals
    the matched GT label, 'incorrect' otherwise; unknown-matched and
    unmatched ('bg') buckets pass through."""
    b = bucket_distributions(pred_json, gt_json, cls_idx, ood_scoring,
                             tiou)
    scores = np.asarray(b['ood_score']['known'], float)
    pl = np.asarray(b['pred_label']['known'], float)
    gl = np.asarray(b['gt_label']['known'], float)
    return {'correct': scores[pl == gl],
            'incorrect': scores[pl != gl],
            'unknown': np.asarray(b['ood_score']['unknown'], float),
            'bg': np.asarray(b['ood_score']['bg'], float)}


def correctness_report(pred_json: str, gt_json: str, cls_idx: str,
                       out_dir: str, ood_scoring: str = 'uncertainty',
                       tiou: float = 0.5) -> List[str]:
    """Correct/incorrect/unknown score distributions + a JSON summary
    (the draw_distribution.py 'corrected classification' figure family
    :513-557 + its printed means)."""
    os.makedirs(out_dir, exist_ok=True)
    b = correctness_buckets(pred_json, gt_json, cls_idx, ood_scoring,
                            tiou)
    written = []
    path = os.path.join(out_dir, 'dist_correctness.png')
    plot_dist(path, [b['correct'], b['incorrect'], b['unknown']],
              ['green', 'orange', 'red'],
              ['Correct', 'Incorrect', 'Unknown'], xlabel=ood_scoring)
    written.append(path)
    path = os.path.join(out_dir, 'dist_correctness_bg.png')
    plot_dist(path, [np.concatenate([b['correct'], b['incorrect']]),
                     b['bg']], ['green', 'gray'],
              ['Matched', 'Background'], xlabel=ood_scoring)
    written.append(path)
    summary = {k: {'n': int(len(v)),
                   'mean': float(np.mean(v)) if len(v) else None}
               for k, v in b.items()}
    path = os.path.join(out_dir, 'correctness_summary.json')
    with open(path, 'w') as f:
        json.dump(summary, f, indent=1)
    written.append(path)
    return written


def stats_report(named_preds: Dict[str, str], gt_json: str, cls_idx: str,
                 out_dir: str, ood_scoring: str = 'uncertainty',
                 tiou: float = 0.3) -> List[str]:
    """The analyze_stats.py figure set (experiments/analyze_stats.py):
    per-method prediction-bucket fractions (background / known /
    unknown, stats.png), mean ood score per bucket per method
    (stats_ood_scores.png), and per-class Wilderness Impact curves over
    tIoU (wi_<class>.png, :152-192). `named_preds` maps method name ->
    detection JSON."""
    plt = _plt()
    os.makedirs(out_dir, exist_ok=True)
    written = []
    buckets = {name: bucket_distributions(pred, gt_json, cls_idx,
                                          ood_scoring, tiou)
               for name, pred in named_preds.items()}

    names = list(buckets)
    kinds = ('bg', 'known', 'unknown')
    x = np.arange(len(names))
    plt.figure(figsize=(8, 4))
    for j, kind in enumerate(kinds):
        counts = [len(buckets[n]['ood_score'][kind]) for n in names]
        totals = [max(sum(len(buckets[n]['ood_score'][k])
                          for k in kinds), 1) for n in names]
        frac = [c / t for c, t in zip(counts, totals)]
        plt.bar(x + (j - 1) * 0.25, frac, width=0.25, label=kind)
    plt.xticks(x, names, rotation=15)
    plt.ylabel('fraction of predictions')
    plt.legend()
    plt.tight_layout()
    path = os.path.join(out_dir, 'stats.png')
    plt.savefig(path)
    plt.close()
    written.append(path)

    path = os.path.join(out_dir, 'stats_ood_scores.png')
    ood_bar_comparison(buckets, path)
    written.append(path)

    # per-class WI curves over a tIoU sweep (analyze_stats.py:152-192)
    from opental_torch.eval.detection import DetectionEvaluator
    tious = np.arange(0.1, 1.0, 0.1)
    for name, pred in named_preds.items():
        ev = DetectionEvaluator(gt_json, pred, cls_idx,
                                tiou_thresholds=tious,
                                ood_scoring=ood_scoring, subset=['test'],
                                openset=True)
        _, _, wi = ev.evaluate('WI')          # (T, C)
        classes = sorted(ev.activity_index,
                         key=ev.activity_index.get)
        plt.figure(figsize=(8, 5))
        for ci, cls in enumerate(classes):
            if cls == '__unknown__':
                continue
            plt.plot(tious, wi[:, ev.activity_index[cls] - 1],
                     label=cls, lw=1)
        plt.xlabel('tIoU')
        plt.ylabel('Wilderness Impact')
        plt.legend(fontsize=6, ncol=2)
        plt.tight_layout()
        path = os.path.join(out_dir, f'wi_{name}.png')
        plt.savefig(path)
        plt.close()
        written.append(path)
    return written


WI_CATEGORIES = ('TP_u2u', 'TP_k2k', 'FP_u2k', 'FP_k2k', 'FP_k2u',
                 'FP_bg2u', 'FP_bg2k')


def wi_category_masks(stats: Dict, tidx: int) -> Dict[str, np.ndarray]:
    """Per-prediction membership mask of each of the 7 TP/FP categories
    at tIoU row `tidx`, from the evaluator's WI stats arrays (the same
    decomposition experiments/analyze_stats.py:33-56 reads from the
    reference's open_stats.pkl). Every prediction of a video with
    ground truth falls in exactly one category per tIoU row."""
    return {
        'TP_u2u': stats['tp_u2u'][tidx] > 0,
        'TP_k2k': stats['tp_k2k'][tidx].sum(axis=0) > 0,
        'FP_u2k': stats['fp_u2k'][tidx].sum(axis=0) > 0,
        'FP_k2k': stats['fp_k2k'][tidx].sum(axis=0) > 0,
        'FP_k2u': stats['fp_k2u'][tidx] > 0,
        'FP_bg2u': stats['fp_bg2u'][tidx] > 0,
        'FP_bg2k': stats['fp_bg2k'][tidx].sum(axis=0) > 0,
    }


def _mean_ci(values: np.ndarray) -> tuple:
    """mean and 1.96*SEM (analyze_stats.py:59-60 get_mean_stds), 0s on
    an empty category (the reference would propagate NaN)."""
    if values.size == 0:
        return 0.0, 0.0
    return float(np.mean(values)), float(
        np.std(values) / np.sqrt(len(values)) * 1.96)


def wi_stats_report(pred_json: str, gt_json: str, cls_idx: str,
                    out_dir: str, ood_scoring: str = 'uncertainty',
                    tious: Sequence[float] = (0.3, 0.4, 0.5, 0.6, 0.7)
                    ) -> List[str]:
    """The per-category analyze_stats.py figure set: segment counts per
    TP/FP category over the tIoU sweep (stats_categories.png,
    experiments/analyze_stats.py:33-56), mean confidence score
    (stats_scores.png, :95-121), mean max-tIoU (stats_tiou.png,
    :124-149) and mean OOD score at every other tIoU
    (stats_ood_scores_categories.png, :63-91), all with 1.96-SEM error
    bars. Category marks and the per-prediction score/ood/max-tIoU
    columns come from the evaluator's WI pass (eval/detection.py
    compute_wilderness_impact stats)."""
    from opental_torch.eval.detection import DetectionEvaluator
    plt = _plt()
    os.makedirs(out_dir, exist_ok=True)
    tious = np.asarray(list(tious), float)
    ev = DetectionEvaluator(gt_json, pred_json, cls_idx,
                            tiou_thresholds=tious,
                            ood_scoring=ood_scoring, subset=['test'],
                            openset=True)
    ev.evaluate('WI')
    stats = ev.stats
    x = np.arange(len(WI_CATEGORIES))
    written = []

    def bar_figure(values_per_pred, fname, ylabel, sel=None,
                   counts=False):
        idxs = sel if sel is not None else range(len(tious))
        plt.figure(figsize=(9, 5))
        w = 0.8 / len(list(idxs))
        for j, i in enumerate(idxs):
            masks = wi_category_masks(stats, i)
            if counts:
                vals = [int(masks[c].sum()) for c in WI_CATEGORIES]
                errs = None
            else:
                pairs = [_mean_ci(values_per_pred[masks[c]])
                         for c in WI_CATEGORIES]
                vals = [p[0] for p in pairs]
                errs = [p[1] for p in pairs]
            off = (j - (len(list(idxs)) - 1) / 2) * w
            plt.bar(x + off, vals, yerr=errs, width=w, alpha=0.6,
                    ecolor='black', label=f'tIoU={tious[i]:g}')
        plt.xticks(x, WI_CATEGORIES, fontsize=8)
        plt.ylabel(ylabel)
        plt.legend(fontsize=8, ncol=3)
        plt.tight_layout()
        path = os.path.join(out_dir, fname)
        plt.savefig(path)
        plt.close()
        written.append(path)

    bar_figure(None, 'stats_categories.png', 'Number of Segments',
               counts=True)
    bar_figure(np.asarray(stats['scores']), 'stats_scores.png',
               'Confidence Scores of Segments')
    bar_figure(np.asarray(stats['max_tious']), 'stats_tiou.png',
               'Max tIoU values')
    bar_figure(np.asarray(stats['ood_scores']),
               'stats_ood_scores_categories.png',
               f'OOD Scores ({ood_scoring})',
               sel=list(range(0, len(tious), 2)))
    return written


def plot_gradnorm(metrics_jsonl: str, out_png: str,
                  key: str = 'grad_norm') -> None:
    """Grad-norm (or any metric) over steps from the train JSONL log
    (analyze_gradnorm.py equivalent over our logging format)."""
    steps, vals = [], []
    with open(metrics_jsonl) as f:
        for line in f:
            rec = json.loads(line)
            if key in rec:
                steps.append(rec['step'])
                vals.append(rec[key])
    plt = _plt()
    plt.figure(figsize=(8, 4))
    plt.plot(steps, vals, lw=0.8)
    plt.xlabel('step')
    plt.ylabel(key)
    plt.yscale('log')
    plt.tight_layout()
    plt.savefig(out_png)
    plt.close()


def compare_auc_curves(named_pickles: Dict[str, str], out_png: str,
                       which: str = 'roc', tidx: int = 0) -> None:
    """Overlay one tIoU's ROC (or PR) curves from several methods'
    saved curve data (draw_auc_comparison.py)."""
    plt = _plt()
    plt.figure(figsize=(8, 5))
    for name, path in named_pickles.items():
        with open(path, 'rb') as f:
            data = pickle.load(f)
        if which == 'roc':
            x, y = data['fpr'][tidx], data['tpr'][tidx]
        else:
            x, y = data['recall'][tidx], data['precision'][tidx]
        plt.plot(x, y, label=f"{name} (auc={data['auc'][tidx]*100:.2f}%)")
    plt.xlabel('FPR' if which == 'roc' else 'Recall')
    plt.ylabel('TPR' if which == 'roc' else 'Precision')
    plt.legend()
    plt.tight_layout()
    plt.savefig(out_png)
    plt.close()


def ood_bar_comparison(named_buckets: Dict[str, Dict], out_png: str
                       ) -> None:
    """Mean OOD score of known vs unknown per method, as grouped bars
    (draw_oodbar_comparison.py)."""
    plt = _plt()
    names = list(named_buckets)
    known = [np.mean(named_buckets[n]['ood_score']['known'] or [0])
             for n in names]
    unknown = [np.mean(named_buckets[n]['ood_score']['unknown'] or [0])
               for n in names]
    x = np.arange(len(names))
    plt.figure(figsize=(8, 4))
    plt.bar(x - 0.2, known, width=0.4, label='known', color='g')
    plt.bar(x + 0.2, unknown, width=0.4, label='unknown', color='r')
    plt.xticks(x, names, rotation=20)
    plt.ylabel('mean OOD score')
    plt.legend()
    plt.tight_layout()
    plt.savefig(out_png)
    plt.close()


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest='cmd', required=True)
    s1 = sub.add_parser('scores')
    s1.add_argument('pred_json')
    s1.add_argument('gt_json')
    s1.add_argument('--cls_idx', required=True)
    s1.add_argument('--ood_scoring', default='uncertainty')
    s1.add_argument('--tiou', type=float, default=0.3)
    s1.add_argument('--out', default='score_dist.png')
    s2 = sub.add_parser('gradnorm')
    s2.add_argument('metrics_jsonl')
    s2.add_argument('--key', default='grad_norm')
    s2.add_argument('--out', default='gradnorm.png')
    s3 = sub.add_parser('compare_auc')
    s3.add_argument('named', nargs='+',
                    help='name=path/to/roc_data.pkl entries')
    s3.add_argument('--which', default='roc', choices=['roc', 'pr'])
    s3.add_argument('--tidx', type=int, default=0)
    s3.add_argument('--out', default='auc_comparison.png')
    s5 = sub.add_parser('correctness')
    s5.add_argument('pred_json')
    s5.add_argument('gt_json')
    s5.add_argument('--cls_idx', required=True)
    s5.add_argument('--ood_scoring', default='uncertainty')
    s5.add_argument('--tiou', type=float, default=0.5)
    s5.add_argument('--out_dir', default='figures')
    s6 = sub.add_parser('wi_stats')
    s6.add_argument('pred_json')
    s6.add_argument('gt_json')
    s6.add_argument('--cls_idx', required=True)
    s6.add_argument('--ood_scoring', default='uncertainty')
    s6.add_argument('--tious', type=float, nargs='+',
                    default=[0.3, 0.4, 0.5, 0.6, 0.7])
    s6.add_argument('--out_dir', default='figures')
    s4 = sub.add_parser('stats')
    s4.add_argument('named', nargs='+', help='name=pred.json entries')
    s4.add_argument('--gt_json', required=True)
    s4.add_argument('--cls_idx', required=True)
    s4.add_argument('--ood_scoring', default='uncertainty')
    s4.add_argument('--tiou', type=float, default=0.3)
    s4.add_argument('--out_dir', default='figures')
    for name in ('distribution', 'actionness', 'per_class'):
        s = sub.add_parser(name)
        s.add_argument('config_file')
        s.add_argument('--gt_json', required=True)
        s.add_argument('--cls_idx', required=True)
        s.add_argument('--out_dir', default='figures')
        s.add_argument('--raw_cache', default=None,
                       help='search_param raw-output cache dir (default '
                            '<output_path>/raw_cache; built if missing)')
        s.add_argument('--open_set', action='store_true')
        s.add_argument('--split', type=int, default=0)
        s.add_argument('--max_videos', type=int, default=None)
        if name in ('distribution', 'per_class'):
            s.add_argument('--ood_scoring', default='uncertainty')
        if name == 'distribution':
            s.add_argument('--pred_json', default=None)
        s.add_argument('--device', type=str, default='cuda',
                       help="device of the network run: 'cuda' (default; "
                            "raises without a card) or 'cpu'")
    args = p.parse_args(argv)

    if args.cmd == 'scores':
        buckets = bucket_distributions(args.pred_json, args.gt_json,
                                       args.cls_idx, args.ood_scoring,
                                       args.tiou)
        plot_score_distributions(buckets, args.out)
        print('wrote', args.out)
    elif args.cmd == 'gradnorm':
        plot_gradnorm(args.metrics_jsonl, args.out, args.key)
        print('wrote', args.out)
    elif args.cmd == 'compare_auc':
        named = dict(e.split('=', 1) for e in args.named)
        compare_auc_curves(named, args.out, args.which, args.tidx)
        print('wrote', args.out)
    elif args.cmd == 'correctness':
        for w in correctness_report(args.pred_json, args.gt_json,
                                    args.cls_idx, args.out_dir,
                                    args.ood_scoring, args.tiou):
            print('wrote', w)
    elif args.cmd == 'stats':
        named = dict(e.split('=', 1) for e in args.named)
        for w in stats_report(named, args.gt_json, args.cls_idx,
                              args.out_dir, args.ood_scoring, args.tiou):
            print('wrote', w)
    elif args.cmd == 'wi_stats':
        for w in wi_stats_report(args.pred_json, args.gt_json,
                                 args.cls_idx, args.out_dir,
                                 args.ood_scoring, args.tious):
            print('wrote', w)
    elif args.cmd in ('distribution', 'actionness', 'per_class'):
        from opental_torch import resolve_device
        from opental_torch.config import load_config
        from opental_torch.tools.search_param import cache_raw_outputs
        device = resolve_device(args.device)
        cfg = load_config(args.config_file, open_set=args.open_set,
                          split=args.split)
        cache_dir = args.raw_cache or os.path.join(
            cfg.testing.get('output_path', './output'), 'raw_cache')
        cache_raw_outputs(cfg, cache_dir, max_videos=args.max_videos,
                          device=device)
        if args.cmd == 'distribution':
            written = distribution_report(
                cfg, cache_dir, args.gt_json, args.cls_idx, args.out_dir,
                target=args.ood_scoring, pred_json=args.pred_json)
        elif args.cmd == 'per_class':
            written = per_class_report(
                cfg, cache_dir, args.gt_json, args.cls_idx, args.out_dir,
                target=args.ood_scoring, max_videos=args.max_videos)
        else:
            written = actionness_report(cfg, cache_dir, args.gt_json,
                                        args.cls_idx, args.out_dir)
        for w in written:
            print('wrote', w)


if __name__ == '__main__':
    main()
