"""OpenMax open-set baseline: MAV extraction and Weibull recalibration.

Counterpart of `opental_tpu/openset/openmax.py` (reference
AFSD/thumos14/test_openmax.py + openmax.py):
 1. per-class Mean Activation Vectors and eucos distances of the class
    heads' input features at positively matched priors of training clips
    (test_openmax.py:248-327);
 2. a Weibull fit of the top-`tailsize` distance tail per class with
    libMR (:331-354);
 3. at test time, per-proposal known-class logits recalibrated, with the
    Weibull-weighted mass moved to an unknown class that takes the
    background column's slot (openmax.py:42-86, test_openmax.py:158-164).

The recalibration is vectorized over proposals (the reference loops per
proposal). Beyond the reference, as the JAX package: a class with no
positive training features gets a placeholder entry whose recalibration
is a no-op (`PARITY.md`).
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from opental_torch.losses.multisegment import match_targets
from opental_torch.openset.libmr import MR
from opental_torch.train.step import device_ingest


def eucos_dist(mav: np.ndarray, feats: np.ndarray) -> np.ndarray:
    """Euclidean / 200 + cosine distance (openmax.py:7-9), vectorized.
    mav (D,); feats (N, D) -> (N,)."""
    feats = np.atleast_2d(feats)
    eu = np.linalg.norm(feats - mav[None, :], axis=1) / 200.0
    denom = np.linalg.norm(feats, axis=1) * np.linalg.norm(mav)
    cos = 1.0 - (feats @ mav) / np.maximum(denom, 1e-12)
    return eu + cos


class OpenMax:
    """Weibull-calibrated open-set probability layer.

    weibull_model: {class_name: {'mean_vec': (D,), 'model': [MR or None]}}.
    """

    def __init__(self, weibull_model: Dict[str, dict], rank: int = 1):
        self.weibull_model = weibull_model
        self.class_names = list(weibull_model.keys())
        self.num_cls = len(self.class_names)
        self.rank = rank

    def __call__(self, logits: np.ndarray, feats: np.ndarray) -> np.ndarray:
        """logits (N, K) known-class logits; feats (N, D). Returns (N, K+1)
        probabilities, the unknown mass first (openmax.py:21-86)."""
        logits = np.asarray(logits, np.float64)
        feats = np.asarray(feats, np.float64)
        n, k = logits.shape
        assert k == self.num_cls

        # ranked alpha weights: the top-`rank` classes by logit weigh
        # ((rank + 1) - i) / rank (openmax.py:47-52)
        alpharank = min(self.num_cls, self.rank)
        order = np.argsort(logits, axis=1)[:, ::-1]
        alpha = np.zeros_like(logits)
        rows = np.arange(n)
        for i in range(alpharank):
            alpha[rows, order[:, i]] = (alpharank - i) / float(alpharank)

        # each class's Weibull rejection probability of each feature; a
        # class with no fitted model contributes 0: its logits pass
        # through and it moves no mass to the unknown slot
        wscores = np.zeros((n, k))
        for ci, name in enumerate(self.class_names):
            entry = self.weibull_model[name]
            if entry['model'][0] is None:
                continue
            dist = eucos_dist(np.asarray(entry['mean_vec'], np.float64),
                              feats)
            wscores[:, ci] = entry['model'][0].w_score_vector(dist)

        modified = logits * (1.0 - wscores * alpha)
        unknown_mass = logits - modified
        denom = (np.sum(np.exp(modified), axis=1)
                 + np.exp(np.sum(unknown_mass, axis=1)))
        probs_known = np.exp(modified) / denom[:, None]
        prob_unknown = np.exp(np.sum(unknown_mass, axis=1)) / denom
        return np.concatenate([prob_unknown[:, None], probs_known], axis=1)


def accumulate_mavs(features: Dict[str, List[np.ndarray]]
                    ) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """Per-class (MAV, eucos distances) of collected feature lists
    (test_openmax.py:312-327); a class with no features is left out."""
    out = {}
    for name, feat_list in features.items():
        if not feat_list:
            continue
        feats = np.stack(feat_list, axis=0)
        mav = feats.mean(axis=0)
        out[name] = (mav, eucos_dist(mav, feats))
    return out


def save_mav_dist(mav_dist_dir: str,
                  coarse: Dict[str, Tuple[np.ndarray, np.ndarray]],
                  refined: Dict[str, Tuple[np.ndarray, np.ndarray]],
                  class_names: Optional[Sequence[str]] = None) -> None:
    """One npz per class. A class missing one stage falls back to the
    other stage's MAV; a class of `class_names` missing both gets a
    placeholder (zero MAV, empty distance tail) that `weibull_fitting`
    turns into a no-op recalibration entry."""
    os.makedirs(mav_dist_dir, exist_ok=True)
    present = set(coarse) | set(refined)
    for name in present:
        fallback = coarse.get(name) or refined.get(name)
        mav, dist = coarse.get(name, fallback)
        mav_p, dist_p = refined.get(name, fallback)
        np.savez(os.path.join(mav_dist_dir, f'{name}.npz'), mav=mav,
                 dist=dist, mav_prop=mav_p, dist_prop=dist_p)
    if class_names and present:
        dim = next(iter((coarse or refined).values()))[0].shape[0]
        zero = np.zeros((dim,))
        empty = np.zeros((0,))
        for name in set(class_names) - present:
            np.savez(os.path.join(mav_dist_dir, f'{name}.npz'), mav=zero,
                     dist=empty, mav_prop=zero, dist_prop=empty)


def weibull_fitting(mav_dist_dir: str, class_names: Sequence[str],
                    tailsize: int = 20
                    ) -> Tuple[Dict[str, dict], Dict[str, dict]]:
    """Per-class Weibull fits of the saved distance tails, coarse and
    refined (test_openmax.py:331-354)."""
    weibull_model: Dict[str, dict] = {}
    weibull_prop_model: Dict[str, dict] = {}
    for name in class_names:
        data = np.load(os.path.join(mav_dist_dir, f'{name}.npz'),
                       allow_pickle=True)
        for model, mav_key, dist_key in (
                (weibull_model, 'mav', 'dist'),
                (weibull_prop_model, 'mav_prop', 'dist_prop')):
            tail = np.sort(data[dist_key])[-tailsize:]
            if tail.size == 0:
                # placeholder (no positive matches): a no-op class
                model[name] = {'mean_vec': data[mav_key], 'model': [None]}
                continue
            mr = MR()
            mr.fit_high(tail, len(tail))
            model[name] = {'mean_vec': data[mav_key], 'model': [mr]}
    return weibull_model, weibull_prop_model


def extract_positive_features(model: torch.nn.Module,
                              batches: Iterable[Dict[str, np.ndarray]],
                              clip_length: int,
                              idx_to_class: Dict[int, str],
                              overlap_thresh: float = 0.5
                              ) -> Tuple[Dict[str, List[np.ndarray]],
                                         Dict[str, List[np.ndarray]]]:
    """The class heads' input features (`get_feat`) of positively matched
    priors over training clips, per class, coarse and refined
    (test_openmax.py:268-311). `batches` yields dicts of numpy clips
    (B, T, H, W, C), uint8 (normalized on the model's device) or float32
    in [-1, 1], with truths / labels / gt_mask; the model runs where its
    parameters are."""
    device = next(model.parameters()).device
    model.eval()
    coarse: Dict[str, List[np.ndarray]] = {n: [] for n in
                                           idx_to_class.values()}
    refined: Dict[str, List[np.ndarray]] = {n: [] for n in
                                            idx_to_class.values()}
    for batch in batches:
        b = device_ingest({k: torch.from_numpy(np.asarray(batch[k])).to(
            device) for k in ('clips', 'truths', 'labels', 'gt_mask')})
        with torch.inference_mode():
            out = model(b['clips'], get_feat=True)
            m = match_targets(out['priors'], out['loc'].float(),
                              b['truths'], b['labels'], b['gt_mask'],
                              clip_length, overlap_thresh)
        for labels, feats, store in (
                (m.conf_t, out['conf_feat'], coarse),
                (m.prop_conf_t, out['prop_conf_feat'], refined)):
            labels = labels.reshape(-1).cpu().numpy()
            feats = feats.reshape(-1, feats.shape[-1]).float().cpu().numpy()
            pos = labels > 0
            for cl, f in zip(labels[pos], feats[pos]):
                store[idx_to_class[int(cl)]].append(f)
    return coarse, refined
