"""Config -> model, loss configuration and loss weights (counterpart of
`opental_tpu/factory.py`).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
from torch import nn

from opental_torch.config import Config
from opental_torch.losses.edl import EDLConfig
from opental_torch.losses.multisegment import LossConfig
from opental_torch.models.anet_pyramid import reinit_anet_heads
from opental_torch.models.bdnet import BDNet
from opental_torch.models.layers import (FrozenBatchNorm, GroupNorm32,
                                         RPLHead)
from opental_torch.train.step import LossWeights


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
        'dropout': model.get('dropout', 0.0),
        'arch': model.get('arch', 'thumos'),
    }


def build_model(cfg: Config, frame_num: Optional[int] = None,
                crop_size: Optional[int] = None,
                dtype: Optional[torch.dtype] = None,
                in_channels: Optional[int] = None) -> BDNet:
    """The BDNet a config describes (`model.arch`: thumos, default, or
    anet). Train and eval are the
    module's modes (`.train()` turns on dropout and, with
    `model.freeze_bn: false`, batch-statistics BN). dtype None reads
    `model.compute_dtype` (bfloat16 | float32, default float32).
    in_channels overrides `model.in_channels` (2 for the flow stream of
    two-stream fusion).

    `model.remat` recomputes the backbone's blocks in the backward
    (`torch.utils.checkpoint`, as `opental_tpu/factory.py:61-64` reads
    it). `model.transformer` makes the conf head a transformer encoder.
    `model.trunk_tfold` selects the TPU's folded-trunk formulation of the
    same math (`opental_tpu/factory.py:58`): the port has one, so it
    changes nothing here."""
    flags = model_flags(cfg)
    if in_channels is not None:
        flags['in_channels'] = in_channels
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
        # reference BN freeze modes (thumos14/BDNet.py:39-49), carried
        # apart as the JAX factory does (factory.py:44-46)
        freeze_bn=bool(cfg.get_path('model.freeze_bn', True)),
        freeze_bn_affine=bool(cfg.get_path('model.freeze_bn_affine', True)),
        dropout=float(flags['dropout'] or 0.0),
        # the packed space-to-depth stem, default off, as the JAX factory
        # reads it (factory.py:60)
        stem_pallas=bool(cfg.get_path('model.stem_pallas', False)),
        arch=flags['arch'], use_rpl=bool(flags['use_rpl']),
        remat=bool(cfg.get_path('model.remat', False)),
        transformer=bool(flags['transformer']),
        dtype=None if dtype == torch.float32 else dtype)


def cls_loss_type(cfg: Config) -> str:
    if cfg.get_path('training.edl_loss', False):
        return 'edl'
    if cfg.get_path('training.rpl_loss', False):
        return 'rpl'
    return 'focal'


def build_loss_config(cfg: Config) -> LossConfig:
    """The detection loss a config describes (factory.py:77-123)."""
    flags = model_flags(cfg)
    num_cls = flags['num_classes'] - (1 if flags['os_head'] else 0)
    kind = cls_loss_type(cfg)
    edl = None
    if kind == 'edl':
        e = cfg.get_path('training.edl_config', {}) or {}
        edl = EDLConfig(
            num_classes=num_cls,
            loss_type=e.get('loss_type', 'log'),
            evidence=e.get('evidence', 'exp'),
            with_focal=e.get('with_focal', False),
            alpha=e.get('alpha', 0.25),
            gamma=e.get('gamma', 2.0),
            soft_label=e.get('soft_label', 0.0),
            iou_aware=e.get('iou_aware', False),
            with_ghm=e.get('with_ghm', False),
            with_ibloss=e.get('with_ibloss', False),
            with_ibm=e.get('with_ibm', False),
            num_bins=e.get('num_bins', 50),
            momentum=e.get('momentum', 0.99),
            ghm_start=e.get('ghm_start', 0),
            ib_start=e.get('ib_start', 10),
            ibm_start=e.get('ibm_start', 0),
        )
        if flags['arch'] == 'anet' and edl.with_ibm:
            # ANet ships the older exp-form MIB (anet/cls_loss.py:225-231)
            edl = edl._replace(ibm_exp=True,
                               ibm_coeff=e.get('ibm_coeff', 10.0))
    act = cfg.get_path('training.act_config', {}) or {}
    rpl = cfg.get_path('training.rpl_config', {}) or {}
    return LossConfig(
        num_classes=num_cls,
        clip_length=cfg.get_path('dataset.training.clip_length', 256),
        piou=cfg.get_path('training.piou', 0.0),
        cls_type=kind,
        edl=edl,
        os_head=flags['os_head'],
        act_margin=act.get('margin', 1.0),
        act_weight=act.get('weight', 0.1),
        rpl_weight_pl=rpl.get('weight_pl', 0.1),
        rpl_temperature=rpl.get('temperature', 1.0),
        rpl_gcpl=rpl.get('gcpl', False),
        variant=flags['arch'],
    )


def build_loss_weights(cfg: Config) -> LossWeights:
    tr = cfg.get_path('training', {})
    return LossWeights(lw=tr.get('lw', 1.0), cw=tr.get('cw', 10.0),
                       ctw=tr.get('ctw', 1.0), actw=tr.get('actw', 1.0),
                       ssl=tr.get('ssl', 0.1))


def _glorot_(w: torch.Tensor, g: torch.Generator) -> None:
    rf = math.prod(w.shape[2:])
    lim = math.sqrt(6.0 / ((w.shape[0] + w.shape[1]) * rf))
    w.copy_((torch.rand(w.shape, generator=g) * 2 - 1) * lim)


def init_train_weights(model: torch.nn.Module, seed: int = 0
                       ) -> torch.nn.Module:
    """Seeded starting weights for training, as the JAX package's init and
    the reference's reset_params give them: glorot-uniform convolutions
    (and the transformer head's dense and attention projections) with
    zero biases; RPL centers 0.1 x normal (`layers.py:469-471` of
    the JAX package); the RPL radius, norms, BN statistics and the
    ScaleExp scales at their defaults. An ANet BDNet then takes the
    normal(0, 0.01) re-init of its tower and head convolutions
    (`reinit_anet_heads`, as `opental_tpu/train/loop.py:76-82`)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Conv1d, nn.Conv3d, nn.Linear)):
                _glorot_(mod.weight, g)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.MultiheadAttention):
                _glorot_(mod.in_proj_weight, g)
                mod.in_proj_bias.zero_()
            elif isinstance(mod, RPLHead):
                mod.centers.copy_(0.1 * torch.randn(mod.centers.shape,
                                                    generator=g))
    if getattr(model, 'arch', 'thumos') == 'anet':
        reinit_anet_heads(model.coarse_pyramid_detection, g)
    return model


HEAD_BIAS_STD = 2.0


def init_weights(model: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    """Seeded random weights for runs without a trained checkpoint:
    glorot-uniform convolutions, perturbed norms and BN statistics, class
    and center head biases spread by `HEAD_BIAS_STD`, and actionness head
    biases near +2, so that actionness clears its 0.5 gate with room and
    class scores spread across conf_thresh; RPL centers 0.1 x normal; the
    transformer head's projections glorot-uniform with biases and
    LayerNorms perturbed (its class Dense's bias spread as a conf
    head's)."""
    g = torch.Generator().manual_seed(seed)

    def normal(t, std, mean=0.0):
        t.copy_(torch.randn(t.shape, generator=g) * std + mean)

    with torch.no_grad():
        for name, mod in model.named_modules():
            if isinstance(mod, (nn.Conv1d, nn.Conv3d, nn.Linear)):
                _glorot_(mod.weight, g)
                if mod.bias is None:
                    continue
                if name.endswith('actionness_head.conv1d'):
                    normal(mod.bias, 0.5, 2.0)
                elif name.endswith(('center_head.conv1d',
                                    'conf_head.conv1d', 'conf_head.fc')):
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
            elif isinstance(mod, nn.MultiheadAttention):
                _glorot_(mod.in_proj_weight, g)
                normal(mod.in_proj_bias, 0.1)
            elif isinstance(mod, (GroupNorm32, nn.LayerNorm)):
                normal(mod.weight, 0.1, 1.0)
                normal(mod.bias, 0.1)
            elif isinstance(mod, RPLHead):
                normal(mod.centers, 0.1)
    return model
