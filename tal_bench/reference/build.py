"""The reference model, loss and step settings a configuration describes
(a frozen copy of the port's `factory.py` semantics, read from the
configuration's plain dict)."""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from tal_bench.reference.bdnet import BDNet
from tal_bench.reference.edl import EDLConfig
from tal_bench.reference.multisegment import LossConfig
from tal_bench.reference.step import LossWeights


def _get(cfg: Dict[str, Any], dotted: str, default: Any = None) -> Any:
    cur: Any = cfg
    for part in dotted.split('.'):
        if not isinstance(cur, dict) or part not in cur:
            return default
        cur = cur[part]
    return cur


def model(cfg: Dict[str, Any], frame_num: int, crop_size: int,
          dtype: Any = None) -> BDNet:
    """The configuration's BDNet at `frame_num` x `crop_size`, computing
    in `dtype` (None: float32; `layers.FP8`: simulated e4m3)."""
    m = cfg.get('model', {})
    return BDNet(
        in_channels=m.get('in_channels', 3),
        num_classes=_get(cfg, 'dataset.num_classes', 16),
        os_head=m.get('os_head', False), use_edl=m.get('use_edl', False),
        evidence=m.get('evidence', 'exp'), frame_num=frame_num,
        crop_size=crop_size, freeze_bn=bool(m.get('freeze_bn', True)),
        freeze_bn_affine=bool(m.get('freeze_bn_affine', True)),
        dropout=float(m.get('dropout', 0.0) or 0.0),
        arch=m.get('arch', 'thumos'), dtype=dtype)


def loss_config(cfg: Dict[str, Any]) -> LossConfig:
    m = cfg.get('model', {})
    tr = cfg.get('training', {})
    arch = m.get('arch', 'thumos')
    os_head = m.get('os_head', False)
    num_cls = _get(cfg, 'dataset.num_classes', 16) - (1 if os_head else 0)
    if not tr.get('edl_loss', False):
        raise ValueError('the reference covers the EDL configurations')
    e = tr.get('edl_config', {}) or {}
    edl = EDLConfig(
        num_classes=num_cls, loss_type=e.get('loss_type', 'log'),
        evidence=e.get('evidence', 'exp'),
        with_focal=e.get('with_focal', False), alpha=e.get('alpha', 0.25),
        gamma=e.get('gamma', 2.0), soft_label=e.get('soft_label', 0.0),
        iou_aware=e.get('iou_aware', False),
        with_ghm=e.get('with_ghm', False),
        with_ibloss=e.get('with_ibloss', False),
        with_ibm=e.get('with_ibm', False),
        num_bins=e.get('num_bins', 50), momentum=e.get('momentum', 0.99),
        ghm_start=e.get('ghm_start', 0), ib_start=e.get('ib_start', 10),
        ibm_start=e.get('ibm_start', 0))
    if arch == 'anet' and edl.with_ibm:
        edl = edl._replace(ibm_exp=True, ibm_coeff=e.get('ibm_coeff', 10.0))
    act = tr.get('act_config', {}) or {}
    return LossConfig(
        num_classes=num_cls,
        clip_length=_get(cfg, 'dataset.training.clip_length', 256),
        piou=tr.get('piou', 0.0), cls_type='edl', edl=edl,
        os_head=os_head, act_margin=act.get('margin', 1.0),
        act_weight=act.get('weight', 0.1), variant=arch)


def loss_weights(cfg: Dict[str, Any]) -> LossWeights:
    tr = cfg.get('training', {})
    return LossWeights(lw=tr.get('lw', 1.0), cw=tr.get('cw', 10.0),
                       ctw=tr.get('ctw', 1.0), actw=tr.get('actw', 1.0),
                       ssl=tr.get('ssl', 0.1))


def load(module: torch.nn.Module, state_dict: Dict[str, torch.Tensor],
         device: Optional[torch.device] = None) -> torch.nn.Module:
    """`module` with a copy of `state_dict` (strict), on `device`."""
    module.load_state_dict({k: v.detach().clone()
                            for k, v in state_dict.items()}, strict=True)
    return module.to(device) if device is not None else module
