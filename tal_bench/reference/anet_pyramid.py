"""Coarse-to-fine pyramid, ActivityNet variant (768-frame clips).

Counterpart of `opental_tpu/models/anet_pyramid.py` (reference
AFSD/anet/BDNet.py:120-391). It differs from the THUMOS pyramid
(`models/pyramid.py`) in three places and shares everything else, the
two grouped pool calls per forward included:
 * level 0 comes from Mixed_5c alone through a spatial-valid Unit3D (no
   Mixed_4f merge), so the levels have T/8, T/16, ... T/256 rows (96 to 3
   at 768 frames) and the frame-level pool has 189 windows;
 * each level's coarse offsets are multiplied by its FPN stride (4 to
   128) before they set the pooling windows;
 * the priors carry (center, level index) -> (P, 2); the level index
   drives the per-level regression ranges of the ANet loss.
Module names follow the reference ANet state_dict: only `pyramids.0` is a
Unit3D. `reinit_anet_heads` is the reference's normal(0, 0.01) re-init of
the tower and head convolutions (anet/BDNet.py:435-451) for training
from scratch.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
from torch import nn

from tal_bench.reference.layers import ConvGNReLU1D
from tal_bench.reference.pyramid import (CONV_CHANNELS, LAYER_NUM,
                                          CoarsePyramid, backbone_spatial,
                                          input_conv)

FPN_STRIDES = (4, 8, 16, 32, 64, 128)
# per-level regression ranges of the ANet matcher
# (anet/multisegment_loss.py:69)
LEVEL_BOUNDS = ((0, 30), (15, 60), (30, 120), (60, 240), (96, 768),
                (256, 768))
# module groups whose Conv1d layers the reference re-initializes
# (anet/BDNet.py:439-447); the actionness heads, the deconv stack and the
# pyramid ladder keep their glorot init
ANET_REINIT_MODULES = ('loc_tower', 'conf_tower', 'loc_head', 'conf_head',
                       'loc_proposal_branch', 'conf_proposal_branch',
                       'prop_loc_head', 'prop_conf_head', 'center_head')


def make_anet_priors(frame_num: int = 768,
                     layer_num: int = LAYER_NUM) -> np.ndarray:
    """(P, 2) priors [(c + 0.5) / t, level] (anet/BDNet.py:262-269): 189
    for 768-frame clips (t = 96, 48, ..., 3)."""
    rows = []
    t = frame_num // 8
    for lvl in range(layer_num):
        centers = (np.arange(t, dtype=np.float32) + 0.5) / t
        rows.append(np.stack([centers, np.full(t, lvl, np.float32)], 1))
        t //= 2
    return np.concatenate(rows, 0)


class AnetCoarsePyramid(CoarsePyramid):
    """6-level pyramid over Mixed_5c with stride-scaled localization."""

    loc_strides = FPN_STRIDES

    def __init__(self, num_classes: int, frame_num: int = 768,
                 crop_size: int = 96, os_head: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(num_classes, frame_num=frame_num,
                         crop_size=crop_size, os_head=os_head, dtype=dtype)

    @staticmethod
    def make_level_priors(frame_num: int) -> np.ndarray:
        return make_anet_priors(frame_num)

    @staticmethod
    def _make_pyramids(crop_size: int, dtype: Optional[torch.dtype]
                       ) -> nn.ModuleList:
        return nn.ModuleList(
            [input_conv(1024, backbone_spatial(crop_size)[1], dtype)]
            + [ConvGNReLU1D(CONV_CHANNELS, CONV_CHANNELS, 3, stride=2,
                            dtype=dtype) for _ in range(1, LAYER_NUM)])

    def level_features(self, feat_dict):
        x = self.pyramids[0](feat_dict['Mixed_5c']).flatten(2)  # (B, 512, T/8)
        feats: List[torch.Tensor] = [x]
        for i in range(1, LAYER_NUM):
            x = self.pyramids[i](x)
            feats.append(x)
        return feats


@torch.no_grad()
def reinit_anet_heads(pyramid: nn.Module, generator: torch.Generator,
                      std: float = 0.01) -> None:
    """normal(0, std) weights and zero biases for every Conv1d of the nine
    `ANET_REINIT_MODULES` groups of `pyramid`, in place, drawn from
    `generator` (anet/BDNet.py:448-451); GroupNorm is untouched."""
    for name, mod in pyramid.named_modules():
        if (isinstance(mod, nn.Conv1d)
                and name.split('.')[0] in ANET_REINIT_MODULES):
            mod.weight.copy_(torch.randn(mod.weight.shape,
                                         generator=generator) * std)
            if mod.bias is not None:
                mod.bias.zero_()
