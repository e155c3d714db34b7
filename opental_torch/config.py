"""Configuration system.

The port's own copy of `opental_tpu/config.py` (the port imports nothing
of the JAX package). YAML schema is kept compatible with the reference
configs (parsed by AFSD/common/config.py:5-101) so that reference
experiment configs port verbatim. Unlike the reference —
which materializes a module-level singleton dict at import time — this is a
plain object you construct explicitly, so library code stays importable.
"""

from __future__ import annotations

import argparse
import copy
from typing import Any, Dict, Optional

import yaml


class Config(dict):
    """A nested dict with attribute access: cfg.model.in_channels."""

    def __getattr__(self, name: str) -> Any:
        try:
            v = self[name]
        except KeyError as e:
            raise AttributeError(name) from e
        return v

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    @staticmethod
    def wrap(obj: Any) -> Any:
        if isinstance(obj, dict):
            return Config({k: Config.wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [Config.wrap(v) for v in obj]
        return obj

    def get_path(self, dotted: str, default: Any = None) -> Any:
        cur: Any = self
        for part in dotted.split('.'):
            if not isinstance(cur, dict) or part not in cur:
                return default
            cur = cur[part]
        return cur

    def clone(self) -> "Config":
        return Config.wrap(copy.deepcopy(dict(self)))


# Open-set split path templating: every path in the reference configs that
# depends on the open split carries a `{id:d}` placeholder
# (AFSD/common/config.py:85-96).
_SPLIT_TEMPLATED = [
    ('dataset', 'class_info_path'),
    ('dataset', 'training', 'video_anno_path'),
    ('dataset', 'testing', 'video_anno_path'),
    ('training', 'checkpoint_path'),
    ('testing', 'checkpoint_path'),
    ('testing', 'output_path'),
]


def _apply_split(data: Dict[str, Any], split: int) -> None:
    for keys in _SPLIT_TEMPLATED:
        cur = data
        for k in keys[:-1]:
            cur = cur.get(k, {})
        leaf = keys[-1]
        if leaf in cur and isinstance(cur[leaf], str):
            cur[leaf] = cur[leaf].format(id=split)
    # video_info paths are only templated when they point into a split dir
    for phase in ('training', 'testing'):
        d = data.get('dataset', {}).get(phase, {})
        p = d.get('video_info_path')
        if isinstance(p, str) and 'split_' in p:
            d['video_info_path'] = p.format(id=split)


def load_config(
    config_file: str,
    open_set: bool = False,
    split: int = 0,
    overrides: Optional[Dict[str, Any]] = None,
) -> Config:
    """Load a YAML config, optionally materializing an open-set split.

    `overrides` maps dotted paths to values, e.g. {"training.batch_size": 4}.
    """
    with open(config_file, 'r', encoding='utf-8') as f:
        data = yaml.safe_load(f.read())

    tr = data.setdefault('training', {})
    tr['learning_rate'] = float(tr.get('learning_rate', 1e-5))
    tr['weight_decay'] = float(tr.get('weight_decay', 1e-3))
    # loss weights the reference passes via argparse defaults
    # (AFSD/common/config.py:23-28)
    tr.setdefault('lw', 1.0)
    tr.setdefault('cw', 10.0)
    tr.setdefault('ctw', 1.0)
    tr.setdefault('actw', 1.0)
    tr.setdefault('ssl', 0.1)
    tr.setdefault('piou', 0.0)
    tr.setdefault('resume', 0)
    te = data.setdefault('testing', {})
    te.setdefault('fusion', False)
    te.setdefault('split', split)
    te.setdefault('ood_scoring', 'confidence')

    data['open_set'] = open_set
    if open_set:
        _apply_split(data, split)
        te['split'] = split

    if overrides:
        for dotted, value in overrides.items():
            cur = data
            parts = dotted.split('.')
            for p in parts[:-1]:
                cur = cur.setdefault(p, {})
            cur[parts[-1]] = value

    return Config.wrap(data)


def build_arg_parser() -> argparse.ArgumentParser:
    """CLI surface mirroring the reference (AFSD/common/config.py:6-38)."""
    p = argparse.ArgumentParser()
    p.add_argument('config_file', type=str, nargs='?',
                   default='configs/default.yaml')
    p.add_argument('--batch_size', type=int)
    p.add_argument('--learning_rate', type=float)
    p.add_argument('--weight_decay', type=float)
    p.add_argument('--max_epoch', type=int)
    p.add_argument('--checkpoint_path', type=str)
    p.add_argument('--seed', type=int)
    p.add_argument('--focal_loss', type=bool)
    p.add_argument('--nms_thresh', type=float)
    p.add_argument('--nms_sigma', type=float)
    p.add_argument('--top_k', type=int)
    p.add_argument('--output_json', type=str)
    p.add_argument('--lw', type=float, default=None)
    p.add_argument('--cw', type=float, default=None)
    p.add_argument('--ctw', type=float, default=None)
    p.add_argument('--actw', type=float, default=None)
    p.add_argument('--ssl', type=float, default=None)
    p.add_argument('--piou', type=float, default=None)
    p.add_argument('--resume', type=int, default=None)
    # data-parallel training over all visible devices (the reference
    # analog is its default DataParallel wrap, train.py:316)
    p.add_argument('--use_mesh', action='store_true', default=None)
    # ship raw uint8 training clips; normalize on device (exact, 4x
    # less host->device transfer per step)
    p.add_argument('--uint8_ingest', action='store_true', default=None)
    p.add_argument('--fusion', action='store_true')
    p.add_argument('--open_set', action='store_true')
    p.add_argument('--split', type=int, choices=[0, 1, 2, 3, 4], default=0)
    p.add_argument('--ood_scoring', type=str, default='confidence',
                   choices=['uncertainty', 'confidence',
                            'uncertainty_actionness', 'a_by_inv_u',
                            'u_by_inv_a', 'half_au'])
    p.add_argument('--exp_tag', type=str, default=None)
    return p


def config_from_namespace(args) -> Config:
    """Build a Config from an already-parsed argparse namespace (for
    tools that extend build_arg_parser with their own flags)."""
    overrides: Dict[str, Any] = {}
    simple = {
        'batch_size': 'training.batch_size',
        'learning_rate': 'training.learning_rate',
        'weight_decay': 'training.weight_decay',
        'max_epoch': 'training.max_epoch',
        'seed': 'training.random_seed',
        'focal_loss': 'training.focal_loss',
        'nms_thresh': 'testing.nms_thresh',
        'nms_sigma': 'testing.nms_sigma',
        'top_k': 'testing.top_k',
        'output_json': 'testing.output_json',
        'lw': 'training.lw', 'cw': 'training.cw', 'ctw': 'training.ctw',
        'actw': 'training.actw', 'ssl': 'training.ssl',
        'piou': 'training.piou', 'resume': 'training.resume',
        'use_mesh': 'training.use_mesh',
        'uint8_ingest': 'training.uint8_ingest',
        'exp_tag': 'testing.exp_tag',
    }
    for k, dotted in simple.items():
        v = getattr(args, k, None)
        if v is not None:
            overrides[dotted] = v
    if args.checkpoint_path is not None:
        overrides['training.checkpoint_path'] = args.checkpoint_path
        overrides['testing.checkpoint_path'] = args.checkpoint_path
    overrides['testing.fusion'] = args.fusion
    overrides['testing.ood_scoring'] = args.ood_scoring
    return load_config(args.config_file, open_set=args.open_set,
                       split=args.split, overrides=overrides)
