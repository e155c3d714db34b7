"""Config -> model factory (counterpart of `opental_tpu/factory.py:20-66`).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from opental_torch.config import Config
from opental_torch.models.bdnet import BDNet
from opental_torch.models.layers import FrozenBatchNorm, GroupNorm32


def model_flags(cfg: Config) -> Dict[str, Any]:
    model = cfg.get_path('model', {})
    return {
        'in_channels': model.get('in_channels', 3),
        'num_classes': cfg.get_path('dataset.num_classes', 16),
        'os_head': model.get('os_head', False),
        'use_edl': model.get('use_edl', False),
        'use_rpl': model.get('use_rpl', False),
        'evidence': model.get('evidence', 'exp'),
        'transformer': model.get('transformer', False),
        'arch': model.get('arch', 'thumos'),
    }


def build_model(cfg: Config, frame_num: Optional[int] = None,
                crop_size: Optional[int] = None,
                dtype: Optional[torch.dtype] = None) -> BDNet:
    """The THUMOS BDNet a config describes, for inference (dropout is
    the identity there). dtype None reads `model.compute_dtype`
    (bfloat16 | float32, default float32)."""
    flags = model_flags(cfg)
    for flag in ('use_rpl', 'transformer'):
        if flags[flag]:
            raise NotImplementedError(f'model.{flag} is not ported yet')
    if flags['arch'] != 'thumos':
        raise NotImplementedError(f'arch {flags["arch"]!r} is not ported '
                                  'yet')
    if dtype is None and cfg.get_path('model.compute_dtype') in (
            'bfloat16', 'bf16'):
        dtype = torch.bfloat16
    return BDNet(
        in_channels=flags['in_channels'],
        num_classes=flags['num_classes'], os_head=flags['os_head'],
        use_edl=flags['use_edl'], evidence=flags['evidence'],
        frame_num=frame_num or cfg.get_path('dataset.training.clip_length',
                                            256),
        crop_size=crop_size or cfg.get_path('dataset.testing.crop_size', 96),
        freeze_bn_affine=bool(cfg.get_path('model.freeze_bn', True)
                              and cfg.get_path('model.freeze_bn_affine',
                                               True)),
        dtype=None if dtype == torch.float32 else dtype)


HEAD_BIAS_STD = 2.0


def init_weights(model: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    """Seeded random weights for runs without a trained checkpoint:
    glorot-uniform convolutions, perturbed norms and BN statistics, class
    and center head biases spread by `HEAD_BIAS_STD`, and actionness head
    biases near +2, so that actionness clears its 0.5 gate with room and
    class scores spread across conf_thresh."""
    g = torch.Generator().manual_seed(seed)

    def normal(t, std, mean=0.0):
        t.copy_(torch.randn(t.shape, generator=g) * std + mean)

    with torch.no_grad():
        for name, mod in model.named_modules():
            if isinstance(mod, (torch.nn.Conv1d, torch.nn.Conv3d)):
                w = mod.weight
                rf = math.prod(w.shape[2:])
                lim = math.sqrt(6.0 / ((w.shape[0] + w.shape[1]) * rf))
                w.copy_((torch.rand(w.shape, generator=g) * 2 - 1) * lim)
                if mod.bias is None:
                    continue
                if name.endswith('actionness_head.conv1d'):
                    normal(mod.bias, 0.5, 2.0)
                elif name.endswith(('center_head.conv1d',
                                    'conf_head.conv1d')):
                    normal(mod.bias, HEAD_BIAS_STD)
                else:
                    normal(mod.bias, 0.1)
            elif isinstance(mod, FrozenBatchNorm):
                normal(mod.weight, 0.1, 1.0)
                normal(mod.bias, 0.1)
                normal(mod.running_mean, 0.2)
                mod.running_var.copy_(
                    0.8 + 0.4 * torch.rand(mod.running_var.shape,
                                           generator=g))
            elif isinstance(mod, GroupNorm32):
                normal(mod.weight, 0.1, 1.0)
                normal(mod.bias, 0.1)
    return model
