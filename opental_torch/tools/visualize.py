"""Qualitative detection visualization.

Reference: experiments/demo/visualization.py — render predicted vs GT
segments for chosen videos as timeline plots (and optionally frame
strips from the npy video).

CLI: python -m opental_torch.tools.visualize <pred.json> <gt.json> \
     --videos v1 v2 --out_dir viz/ [--npy_dir ...] [--threshold 0.X]

Copy of `opental_tpu/tools/visualize.py`: numpy, matplotlib and files
only.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional

import numpy as np


def _plt():
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    return plt


def timeline_figure(video: str, preds: List[dict], gts: List[dict],
                    out_png: str, top_n: int = 10,
                    ood_threshold: Optional[float] = None,
                    frames: Optional[np.ndarray] = None,
                    fps: float = 10.0) -> None:
    plt = _plt()
    preds = sorted(preds, key=lambda p: -p['score'])[:top_n]
    n_rows = 2 if frames is None else 3
    fig, axes = plt.subplots(n_rows, 1, figsize=(10, 2 + n_rows),
                             sharex=(frames is None))
    ax_gt, ax_pred = axes[0], axes[1]

    for g in gts:
        ax_gt.axvspan(g['segment'][0], g['segment'][1], alpha=0.4,
                      color='green')
        ax_gt.text(g['segment'][0], 0.5, g['label'], fontsize=8)
    ax_gt.set_ylabel('GT')
    ax_gt.set_yticks([])

    for i, p in enumerate(preds):
        thr = (ood_threshold.get(video) if isinstance(ood_threshold, dict)
               else ood_threshold)
        rejected = (thr is not None
                    and (1.0 - p.get('uncertainty', 0.0)) < thr)
        color = 'red' if rejected else 'tab:blue'
        y = 1.0 - (i + 0.5) / max(len(preds), 1)
        ax_pred.hlines(y, p['segment'][0], p['segment'][1], color=color,
                       lw=3)
        label = '__unknown__' if rejected else p['label']
        ax_pred.text(p['segment'][0], y + 0.02,
                     f"{label} {p['score']:.2f}", fontsize=7)
    ax_pred.set_ylabel(f'top-{len(preds)} preds')
    ax_pred.set_yticks([])
    ax_pred.set_xlabel('time (s)')

    if frames is not None:
        strip_idx = np.linspace(0, len(frames) - 1, 8).astype(int)
        strip = np.concatenate([frames[i] for i in strip_idx], axis=1)
        axes[2].imshow(strip)
        axes[2].set_yticks([])
        axes[2].set_xticks([])
    fig.suptitle(video)
    fig.tight_layout()
    fig.savefig(out_png, dpi=120)
    plt.close(fig)


def action_bar_figure(video: str, named_preds: Dict[str, List[dict]],
                      gts: List[dict], duration: float, out_png: str,
                      thresholds: Optional[Dict[str, float]] = None,
                      score_thresh: float = 0.2, n_cols: int = 1000
                      ) -> None:
    """Color-coded action-bar comparison strips, one row per method plus
    the GT row (demo/visualization.py draw_action_detections:180-244):
    each row is a timeline painted with a distinct color per class;
    predictions rejected by the method's OOD threshold (composed as
    1 - uncertainty vs the trainset-calibrated cutoff,
    read_threshold:11-18) paint black as '__unknown__'."""
    plt = _plt()
    classes = sorted({g['label'] for g in gts}
                     | {p['label'] for preds in named_preds.values()
                        for p in preds})
    cmap = plt.get_cmap('tab20')
    colors = {c: cmap(i % 20)[:3] for i, c in enumerate(classes)}
    rows = ['GT'] + list(named_preds)
    bars = np.ones((len(rows), n_cols, 3))

    def paint(row, segs):
        for (s, e), color in segs:
            a = int(np.clip(s / max(duration, 1e-6), 0, 1) * (n_cols - 1))
            b = int(np.clip(e / max(duration, 1e-6), 0, 1) * (n_cols - 1))
            bars[row, a:b + 1] = color

    paint(0, [((g['segment'][0], g['segment'][1]), colors[g['label']])
              for g in gts])
    for ri, (name, preds) in enumerate(named_preds.items(), start=1):
        thr = (thresholds or {}).get(name)
        if isinstance(thr, dict):          # per-video searched cutoffs
            thr = thr.get(video)
        segs = []
        for p in sorted(preds, key=lambda q: q['score']):
            if p['score'] < score_thresh:
                continue
            rejected = (thr is not None
                        and 1.0 - p.get('uncertainty', 0.0) < thr)
            color = (0, 0, 0) if rejected else colors[p['label']]
            segs.append(((p['segment'][0], p['segment'][1]), color))
        paint(ri, segs)

    fig, ax = plt.subplots(figsize=(10, 0.6 * len(rows) + 1))
    ax.imshow(bars, aspect='auto', extent=(0, duration, len(rows), 0))
    ax.set_yticks(np.arange(len(rows)) + 0.5)
    ax.set_yticklabels(rows, fontsize=8)
    ax.set_xlabel('time (s)')
    handles = [plt.Rectangle((0, 0), 1, 1, color=colors[c])
               for c in classes] + \
        [plt.Rectangle((0, 0), 1, 1, color=(0, 0, 0))]
    ax.legend(handles, classes + ['__unknown__'], fontsize=6,
              ncol=4, loc='upper center', bbox_to_anchor=(0.5, -0.25))
    fig.suptitle(video)
    fig.tight_layout()
    fig.savefig(out_png, dpi=120)
    plt.close(fig)


def read_threshold(trainset_result_json: str,
                   scoring: str = 'confidence') -> float:
    """Read the calibrated OOD cutoff from a thresholding-run JSON
    (demo/visualization.py:11-18; written by tools/threshold.py)."""
    with open(trainset_result_json) as f:
        return float(json.load(f)['external_data']['threshold'])


def _segment_iou(seg, gt_segs: np.ndarray) -> np.ndarray:
    s, e = seg
    inter = (np.minimum(e, gt_segs[:, 1])
             - np.maximum(s, gt_segs[:, 0])).clip(min=0)
    union = (gt_segs[:, 1] - gt_segs[:, 0]) + (e - s) - inter
    return inter / np.maximum(union, 1e-8)


def match_preds_with_gt(preds: List[dict], gts: List[dict],
                        unct_thresh: float, tiou: float = 0.3
                        ) -> List[tuple]:
    """Greedy per-video pred->GT matching for the demo threshold search
    (demo/visualization.py:100-118): each prediction takes the
    highest-IoU still-unlocked GT at IoU >= tiou, is relabelled
    '__unknown__' when its uncertainty exceeds `unct_thresh`, and
    returns (pred_label, gt_label) pairs for the matched ones.
    Deviation: the reference loop breaks on the first BELOW-threshold
    GT and then matches that background index — an evident demo bug; we
    match the intended above-threshold GT instead."""
    if not gts:
        return []
    gt_segs = np.array([g['segment'] for g in gts], float)
    lock = np.full(len(gts), -1)
    pairs = []
    for idx, p in enumerate(preds):
        tiou_arr = _segment_iou(p['segment'], gt_segs)
        order = np.argsort(tiou_arr)[::-1]
        for j in order:
            if tiou_arr[j] < tiou:
                break
            if lock[j] >= 0:
                continue
            label = ('__unknown__'
                     if p.get('uncertainty', 0.0) > unct_thresh
                     else p['label'])
            lock[j] = idx
            pairs.append((label, gts[j]['label']))
            break
    return pairs


def search_video_thresholds(preds_by_video: Dict[str, List[dict]],
                            gt_db: Dict[str, dict], videos: List[str],
                            tiou: float = 0.3) -> Dict[str, float]:
    """Per-video best uncertainty cutoff (demo/visualization.py
    get_thresholds OpenTAL route, :121-142): sweep candidates
    0.05..0.95 and pick the one maximizing (#correctly-labelled matched
    preds - #incorrect), where a GT labelled unknown counts correct iff
    the prediction was rejected. Returned values are CONFIDENCE cutoffs
    (1 - uncertainty candidate) so they compose directly with
    action_bar_figure/timeline_figure rejection."""
    # predictions can only carry known-class labels, so a GT label
    # outside this set is an unknown action (matches a rejected pred)
    known = {p['label'] for preds in preds_by_video.values()
             for p in preds} - {'__unknown__'}
    out = {}
    for video in videos:
        gts = gt_db.get(video, {}).get('annotations', [])
        preds = preds_by_video.get(video, [])
        candidates = np.arange(0.05, 1.0, 0.05)
        counts = np.zeros(len(candidates))
        for i, t in enumerate(candidates):
            for label_pred, label_gt in match_preds_with_gt(
                    preds, gts, unct_thresh=t, tiou=tiou):
                if label_gt not in known:
                    label_gt = '__unknown__'
                counts[i] += 1 if label_pred == label_gt else -1
        out[video] = float(1.0 - candidates[int(np.argmax(counts))])
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument('pred_json', help='pred.json or name=pred.json pairs',
                   nargs='+')
    p.add_argument('gt_json')
    p.add_argument('--videos', nargs='*', default=None)
    p.add_argument('--out_dir', default='viz')
    p.add_argument('--npy_dir', default=None)
    p.add_argument('--top_n', type=int, default=10)
    p.add_argument('--ood_threshold', type=float, default=None)
    p.add_argument('--bars', action='store_true',
                   help='multi-method color-bar strips '
                        '(demo/visualization.py style)')
    p.add_argument('--thresholds', nargs='*', default=[],
                   help='per-method OOD cutoff routing for --bars '
                        '(demo/visualization.py get_thresholds:121-151): '
                        'name=0.7 fixed, name=path/to/threshold.json '
                        'calibrated (read_threshold), or name=search '
                        'per-video best-match sweep')
    p.add_argument('--search_tiou', type=float, default=0.3)
    args = p.parse_args(argv)

    if args.bars:
        named = {}
        for entry in args.pred_json:
            name, _, path = entry.rpartition('=')
            named[name or os.path.basename(path)] = \
                json.load(open(path))['results']
        gt = json.load(open(args.gt_json))['database']
        videos = args.videos or list(next(iter(named.values())))[:5]
        thresholds = {}
        for entry in args.thresholds:
            name, _, spec = entry.partition('=')
            if spec == 'search':
                thresholds[name] = search_video_thresholds(
                    named.get(name, {}), gt, videos,
                    tiou=args.search_tiou)
            elif os.path.exists(spec):
                thresholds[name] = read_threshold(spec)
            else:
                thresholds[name] = float(spec)
        os.makedirs(args.out_dir, exist_ok=True)
        for video in videos:
            gts = gt.get(video, {}).get('annotations', [])
            duration = max([g['segment'][1] for g in gts] +
                           [p['segment'][1] for preds in named.values()
                            for p in preds.get(video, [])] + [1.0])
            out = os.path.join(args.out_dir, f'{video}_bars.png')
            action_bar_figure(video,
                              {n: r.get(video, []) for n, r in
                               named.items()},
                              gts, duration, out,
                              thresholds=thresholds or None)
            print('wrote', out)
        return
    args.pred_json = args.pred_json[0]

    preds = json.load(open(args.pred_json))['results']
    gt = json.load(open(args.gt_json))['database']
    videos = args.videos or list(preds)[:5]
    os.makedirs(args.out_dir, exist_ok=True)
    for video in videos:
        frames = None
        if args.npy_dir:
            path = os.path.join(args.npy_dir, video + '.npy')
            if os.path.exists(path):
                frames = np.load(path, mmap_mode='r')
        timeline_figure(video, preds.get(video, []),
                        gt.get(video, {}).get('annotations', []),
                        os.path.join(args.out_dir, f'{video}.png'),
                        top_n=args.top_n,
                        ood_threshold=args.ood_threshold, frames=frames)
        print('wrote', os.path.join(args.out_dir, f'{video}.png'))


if __name__ == '__main__':
    main()
