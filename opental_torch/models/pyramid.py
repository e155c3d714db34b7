"""Coarse-to-fine temporal detection pyramid (THUMOS14 variant).

Counterpart of `opental_tpu/models/pyramid.py`; reference
AFSD/thumos14/BDNet.py:64-432. Convolutions run on (B, C, t); the
boundary max pool keeps the JAX op's (B, T, C) contract, so features are
transposed at the op. The returned out_dict has the JAX package's (and
the reference's) layout: (B, P, ...) with P = 126 priors at 256 frames.
Module names follow the reference state_dict
('pyramids.0.0.conv3d.weight', 'loc_tower.1.0.conv1d.weight',
'loc_proposal_branch.lr_conv.1.weight', 'loc_heads.3.scale', ...).
The level loop runs in three stages: per level the towers, heads and the
branches' features; then every boundary pool of the pass in two launches
(the frame-level pool of all levels, shared by both branches, and the lr
features of all levels and both branches packed into one segmented
call); then per level the refinement and proposal heads.
`forward(..., ssl=True)` is the SSL pass: it returns {'trip': [frame-level
feature, loc lr feature, conf lr feature]} right after level 0's branch
features, before any pool. `use_rpl` makes both class heads `RPLHead`s
and adds the learnable RPL radius (`rpl_radius`, which the reference
keeps in its loss module); `get_feat` (and `use_rpl`) adds the class
heads' inputs, `ctr_feat` and `prop_ctr_feat` (B, P, 512), to the
out_dict (`opental_tpu/models/pyramid.py:218-233, 262-303`).
`transformer` makes the conf head a `TransformerHead` (channels-last,
float32; `opental_tpu/models/pyramid.py:184-187`); `prop_conf_head`
stays a Unit1D. Spans (`utils/profiling`): `model.pyramid` (the level
features and the frame-level deconv stack) and `model.heads` (the rest).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from opental_torch.models.layers import (ConvGNReLU1D, GroupNorm32,
                                         RPLHead, ScaleExp, TransformerHead,
                                         Unit1D, Unit3D,
                                         interpolate_nearest_1d)
from opental_torch.ops.boundary_pool import boundary_max_pool_segmented
from opental_torch.utils import profiling

LAYER_NUM = 6
CONV_CHANNELS = 512


def level_sizes(frame_num: int, layer_num: int = LAYER_NUM) -> List[int]:
    """Temporal length of each pyramid level: frame_num / 4, halved."""
    feat_t = frame_num // 4
    return [feat_t // (1 << i) for i in range(layer_num)]


def make_priors(frame_num: int, layer_num: int = LAYER_NUM) -> np.ndarray:
    """Per-level center priors (c + 0.5) / t, concatenated (P, 1)."""
    return np.concatenate([(np.arange(t, dtype=np.float32) + 0.5) / t
                           for t in level_sizes(frame_num, layer_num)]
                          )[:, None]


def backbone_spatial(crop_size: int) -> Tuple[int, int]:
    """Spatial extent of Mixed_4f and Mixed_5c for a square crop: every
    stride-2 SAME op maps n to ceil(n / 2) (stem, 2a, 3a, 4a; then 5a)."""
    n = crop_size
    for _ in range(4):
        n = -(-n // 2)
    return n, -(-n // 2)


def expand_boundary_segments(left: torch.Tensor, right: torch.Tensor,
                             plus_one: bool = False) -> torch.Tensor:
    """[l-out, l+in, r-in, r+out] with in = max(w/4, 1), out =
    max(w/10, 1), rounded half to even (thumos14/BDNet.py:355-384);
    left/right (..., 1)."""
    plen = right - left
    if plus_one:
        plen = plen + 1.0
    in_plen = torch.clamp(plen / 4.0, min=1.0)
    out_plen = torch.clamp(plen / 10.0, min=1.0)
    return torch.cat([torch.round(left - out_plen),
                      torch.round(left + in_plen),
                      torch.round(right - in_plen),
                      torch.round(right + out_plen)], dim=-1)


def proposal_segments(loc: torch.Tensor, frame_num: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pooling windows of one level from its coarse offsets loc (B, t, 2):
    (segments in level units, frame_segments in frame units), each
    (B, t, 4) float32."""
    t = loc.shape[1]
    prior_center = ((torch.arange(t, dtype=torch.float32,
                                  device=loc.device) + 0.5) / t
                    )[None, :, None]
    seg_scaled = loc / frame_num * t
    new_priors = torch.round(prior_center * t - 0.5)
    segments = expand_boundary_segments(new_priors - seg_scaled[..., :1],
                                        new_priors + seg_scaled[..., 1:])
    decoded_l = prior_center * frame_num - loc[..., :1]
    decoded_r = prior_center * frame_num + loc[..., 1:]
    frame_segments = expand_boundary_segments(decoded_l, decoded_r,
                                              plus_one=True)
    return segments.contiguous(), frame_segments.contiguous()


def _channels_last(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(1, 2)


class ProposalBranch(nn.Module):
    """Boundary-pooled proposal refinement (thumos14/BDNet.py:64-113),
    in two stages around the pools, which `CoarsePyramid` runs for every
    level and both branches at once: `features` before them, `refine`
    after."""

    def __init__(self, in_channels: int = CONV_CHANNELS,
                 proposal_channels: int = 512,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        pc = proposal_channels
        self.cur_point_conv = ConvGNReLU1D(in_channels, pc, 1, dtype=dtype)
        self.lr_conv = ConvGNReLU1D(in_channels, pc * 2, 1, dtype=dtype)
        self.roi_conv = ConvGNReLU1D(CONV_CHANNELS, pc, 1, dtype=dtype)
        self.proposal_conv = ConvGNReLU1D(pc * 4, pc, 1, dtype=dtype)

    def features(self, feature: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """feature (B, C, t) -> (fm_short (B, 512, t), lr feature
        (B, 1024, t), the input of the level's boundary pool)."""
        return self.cur_point_conv(feature), self.lr_conv(feature)

    def refine(self, fm_short: torch.Tensor, prop: torch.Tensor,
               roi: torch.Tensor) -> torch.Tensor:
        """fm_short (B, 512, t); the level's pools, channels-last: prop
        (B, t, 1024) of the lr feature, roi (B, t, 512) of the frame-level
        feature. Returns the proposal feature (B, 512, t)."""
        roi = self.roi_conv(_channels_last(roi))
        return self.proposal_conv(torch.cat(
            [roi, _channels_last(prop), fm_short], dim=1))


def _tower(depth: int = 2, dtype=None) -> nn.Sequential:
    """k3 conv-GN-relu blocks (loc/conf towers, thumos14/BDNet.py:170-203)."""
    return nn.Sequential(*[ConvGNReLU1D(CONV_CHANNELS, CONV_CHANNELS, 3,
                                        dtype=dtype) for _ in range(depth)])


def input_conv(in_channels: int, spatial: int,
               dtype: Optional[torch.dtype] = None) -> nn.Sequential:
    """A pyramid input conv: a spatial-valid Unit3D spanning the whole
    spatial extent (H x W -> 1 x 1), GroupNorm(32), ReLU."""
    return nn.Sequential(
        Unit3D(in_channels, CONV_CHANNELS, (1, spatial, spatial),
               padding='spatial_valid', use_bias=True, use_batch_norm=False,
               activation=False, dtype=dtype),
        GroupNorm32(CONV_CHANNELS), nn.ReLU())


class CoarsePyramid(nn.Module):
    """6-level temporal FPN with coarse heads and proposal refinement.

    Subclasses (the ActivityNet pyramid, `models/anet_pyramid.py`) replace
    `_make_pyramids`, `level_features` and `make_level_priors`, and may
    set `loc_strides`, the per-level multipliers of the coarse offsets."""

    loc_strides: Optional[Tuple[int, ...]] = None

    def __init__(self, num_classes: int, frame_num: int = 256,
                 crop_size: int = 96, os_head: bool = False,
                 dropout: float = 0.0, use_rpl: bool = False,
                 transformer: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        oc = CONV_CHANNELS
        self.frame_num = frame_num
        self.os_head = os_head
        self.use_rpl = use_rpl
        self.pyramids = self._make_pyramids(crop_size, dtype)
        # frame-level feature stack: one flat Sequential as the reference
        # (deconv.{0,3,6} convs, deconv.{1,4,7} GroupNorms)
        self.deconv = nn.Sequential(*[
            m for k in (3, 3, 1)
            for m in ConvGNReLU1D(oc, oc, k, dtype=dtype)])
        self.loc_tower = _tower(dtype=dtype)
        self.conf_tower = _tower(dtype=dtype)
        self.loc_head = Unit1D(oc, 2, 3, activation=False, dtype=dtype)
        if transformer:
            self.conf_head = TransformerHead(num_classes, oc)
        elif use_rpl:
            self.conf_head = RPLHead(num_classes, oc)
        else:
            self.conf_head = Unit1D(oc, num_classes, 3, activation=False,
                                    dtype=dtype)
        if os_head:
            self.actionness_head = Unit1D(oc, 1, 3, activation=False,
                                          dtype=dtype)
            self.prop_actionness_head = Unit1D(oc, 1, 1, activation=False,
                                               dtype=dtype)
        self.loc_proposal_branch = ProposalBranch(oc, 512, dtype=dtype)
        self.conf_proposal_branch = ProposalBranch(oc, 512, dtype=dtype)
        self.prop_loc_head = Unit1D(oc, 2, 1, activation=False, dtype=dtype)
        self.prop_conf_head = (RPLHead(num_classes, oc) if use_rpl else
                               Unit1D(oc, num_classes, 1, activation=False,
                                      dtype=dtype))
        self.center_head = Unit1D(oc, 1, 3, activation=False, dtype=dtype)
        self.loc_heads = nn.ModuleList([ScaleExp()
                                        for _ in range(LAYER_NUM)])
        # on the class heads' inputs only, as the JAX package
        # (pyramid.py:213-231); the identity in eval mode
        self.dropout = nn.Dropout(dropout) if dropout > 0 else None
        if use_rpl:
            self.rpl_radius = nn.Parameter(torch.zeros(1))
        self.register_buffer('priors', torch.from_numpy(
            self.make_level_priors(frame_num)), persistent=False)

    @staticmethod
    def make_level_priors(frame_num: int) -> np.ndarray:
        return make_priors(frame_num)

    @staticmethod
    def _make_pyramids(crop_size: int, dtype: Optional[torch.dtype]
                       ) -> nn.ModuleList:
        # input convs over Mixed_4f and Mixed_5c ((6, 6) / (3, 3) kernels
        # at crop 96), then stride-2 conv blocks
        s4f, s5c = backbone_spatial(crop_size)
        return nn.ModuleList(
            [input_conv(832, s4f, dtype), input_conv(1024, s5c, dtype)]
            + [ConvGNReLU1D(CONV_CHANNELS, CONV_CHANNELS, 3, stride=2,
                            dtype=dtype) for _ in range(2, LAYER_NUM)])

    def level_features(self, feat_dict: Dict[str, torch.Tensor]
                       ) -> List[torch.Tensor]:
        """The LAYER_NUM level features (B, 512, t_i); the first also
        feeds the frame-level feature."""
        x1 = feat_dict['Mixed_4f']            # (B, 832, T/4, h, w)
        x2 = feat_dict['Mixed_5c']            # (B, 1024, T/8, h', w')
        lvl0 = self.pyramids[0](x1).flatten(2)    # (B, 512, T/4)
        lvl1 = self.pyramids[1](x2).flatten(2)    # (B, 512, T/8)
        lvl0 = lvl0 + interpolate_nearest_1d(lvl1, lvl0.shape[-1])
        feats = [lvl0, lvl1]
        x = lvl1
        for i in range(2, LAYER_NUM):
            x = self.pyramids[i](x)
            feats.append(x)
        return feats

    def _drop(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.dropout is None else self.dropout(x)

    def _class_head(self, head: nn.Module, feat: torch.Tensor,
                    taps: Optional[List[torch.Tensor]]) -> torch.Tensor:
        """A class head on (B, 512, t) after dropout -> (B, t, K); the
        head's channels-last input goes to `taps` when it is kept."""
        x = self._drop(feat)
        if isinstance(head, Unit1D):
            if taps is not None:
                taps.append(_channels_last(x))
            return _channels_last(head(x))
        x = _channels_last(x)
        if taps is not None:
            taps.append(x)
        return head(x)

    def forward(self, feat_dict: Dict[str, torch.Tensor], ssl: bool = False,
                get_feat: bool = False) -> Dict[str, Any]:
        with profiling.span('model.pyramid'):
            feats = self.level_features(feat_dict)
            frame_level = self.deconv(interpolate_nearest_1d(
                feats[0], self.frame_num))
        with profiling.span('model.heads'):
            return self._heads(feats, frame_level, ssl, get_feat)

    def _heads(self, feats: List[torch.Tensor], frame_level: torch.Tensor,
               ssl: bool, get_feat: bool) -> Dict[str, Any]:
        """The towers, heads, pools and refinement on the level features
        and the frame-level feature: the out_dict (or the SSL pass's
        triplet features)."""
        frame_tc = _channels_last(frame_level).contiguous()  # (B, T, 512)
        half = CONV_CHANNELS // 2
        out: Dict[str, Any] = {'start': frame_tc[..., :half],
                               'end': frame_tc[..., half:]}

        keep = self.use_rpl or get_feat
        ctr_feats = [] if keep else None
        prop_ctr_feats = [] if keep else None

        # (A) per level: towers, heads, pooling windows, branch features
        locs, confs, acts = [], [], []
        seg_list, frame_seg_list, shorts, lrs = [], [], [], []
        for i, feat in enumerate(feats):
            loc_feat = self.loc_tower(feat)
            conf_feat = self.conf_tower(feat)
            loc_out = self.loc_heads[i](self.loc_head(loc_feat))
            if self.loc_strides is not None:
                loc_out = loc_out * self.loc_strides[i]
            loc_out = _channels_last(loc_out)                 # (B, t, 2)
            locs.append(loc_out)
            confs.append(self._class_head(self.conf_head, conf_feat,
                                          ctr_feats))
            if self.os_head:
                acts.append(_channels_last(self.actionness_head(conf_feat)))

            segments, frame_segments = proposal_segments(
                loc_out.detach(), self.frame_num)
            seg_list.append(segments)
            frame_seg_list.append(frame_segments)
            loc_short, loc_lr = self.loc_proposal_branch.features(loc_feat)
            conf_short, conf_lr = self.conf_proposal_branch.features(
                conf_feat)
            shorts.append((loc_short, conf_short))
            lrs.append((loc_lr, conf_lr))
            if i == 0:
                nd = loc_lr.shape[1] // 2
                loc_lr, conf_lr = _channels_last(loc_lr), \
                    _channels_last(conf_lr)
                out['start_loc_prop'] = loc_lr[..., :nd]
                out['end_loc_prop'] = loc_lr[..., nd:]
                out['start_conf_prop'] = conf_lr[..., :nd]
                out['end_conf_prop'] = conf_lr[..., nd:]
                if ssl:     # nothing reads the pools of this pass
                    return {'trip': [frame_tc, loc_lr, conf_lr]}

        # (B) every pool of the pass in two launches. Both branches pool
        # frame_tc with the same windows: one call over all levels' 126
        # windows, read by both. The lr features of every level and both
        # branches (loc levels, then conf levels) are packed along t as
        # the 12 levels of one segmented call, each window clamped to its
        # own level's rows.
        sizes = [s.shape[1] for s in seg_list]       # t_i windows = rows
        k_all = sum(sizes)
        roi_all = boundary_max_pool_segmented(
            frame_tc, torch.cat(frame_seg_list, dim=1),
            ((frame_tc.shape[1], k_all),))           # (B, 126, 512)
        packed = torch.cat([_channels_last(lr[j]) for j in (0, 1)
                            for lr in lrs], dim=1)   # (B, 2 * 126, 1024)
        prop_all = boundary_max_pool_segmented(
            packed, torch.cat(seg_list * 2, dim=1),
            tuple((t, t) for t in sizes) * 2)        # (B, 2 * 126, 1024)

        # (C) per level: refinement and proposal heads
        prop_locs, prop_confs, prop_acts, centers = [], [], [], []
        k0 = 0
        for t, (loc_short, conf_short) in zip(sizes, shorts):
            roi = roi_all[:, k0:k0 + t]
            loc_prop = self.loc_proposal_branch.refine(
                loc_short, prop_all[:, k0:k0 + t], roi)
            conf_prop = self.conf_proposal_branch.refine(
                conf_short, prop_all[:, k_all + k0:k_all + k0 + t], roi)
            k0 += t
            prop_locs.append(_channels_last(self.prop_loc_head(loc_prop)))
            prop_confs.append(self._class_head(self.prop_conf_head,
                                               conf_prop, prop_ctr_feats))
            if self.os_head:
                prop_acts.append(_channels_last(
                    self.prop_actionness_head(conf_prop)))
            centers.append(_channels_last(self.center_head(loc_prop)))

        def cat(xs):
            return torch.cat(xs, dim=1)

        out.update({
            'loc': cat(locs), 'conf': cat(confs),
            'prop_loc': cat(prop_locs), 'prop_conf': cat(prop_confs),
            'center': cat(centers), 'priors': self.priors,
            'act': cat(acts) if self.os_head else None,
            'prop_act': cat(prop_acts) if self.os_head else None,
        })
        if keep:
            out['ctr_feat'] = cat(ctr_feats)
            out['prop_ctr_feat'] = cat(prop_ctr_feats)
        if self.use_rpl:
            # the reciprocal points and the radius of the RPL loss
            # (thumos14/BDNet.py:528-532)
            out['cls_ctr'] = self.conf_head.centers
            out['prop_cls_ctr'] = self.prop_conf_head.centers
            out['rpl_radius'] = self.rpl_radius
        return out
