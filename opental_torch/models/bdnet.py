"""BDNet: I3D backbone + coarse pyramid + evidential head (PyTorch).

Counterpart of `opental_tpu/models/bdnet.py`; reference
AFSD/thumos14/BDNet.py:435-561. Input clips are (B, C, T, H, W) in
[-1, 1] (the reference's layout); the out_dict has the JAX package's keys
and layouts. Top-level names ('backbone._model', 'coarse_pyramid_detection')
follow the reference state_dict. `ssl_forward` is the SSL triplet pass of
training (bdnet.py:166-192). `backbone_features` and
`detect_from_features` split the forward at the backbone, as the
shared-backbone inference runs it; `get_feat` adds the class heads'
inputs (`conf_feat`, `prop_conf_feat`) that OpenMax reads
(bdnet.py:100-123).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from opental_torch.models.anet_pyramid import AnetCoarsePyramid
from opental_torch.models.i3d import InceptionI3d
from opental_torch.models.pyramid import (CoarsePyramid,
                                          expand_boundary_segments)
from opental_torch.ops.boundary_pool import boundary_max_pool_segmented

SSL_SCALES = (1.0, 4.0, 4.0)


def evidence_fn(logit: torch.Tensor, evidence: str = 'exp') -> torch.Tensor:
    """Dirichlet evidence transform (thumos14/BDNet.py:544-550)."""
    if evidence == 'relu':
        return torch.relu(logit)
    if evidence == 'exp':
        return torch.exp(torch.clamp(logit, -10.0, 10.0))
    if evidence == 'softplus':
        return nn.functional.softplus(logit)
    raise ValueError(evidence)


def dirichlet_uncertainty(logit: torch.Tensor, evidence: str = 'exp'
                          ) -> torch.Tensor:
    """Vacuity u = K / sum(alpha), alpha = evidence + 1."""
    k = logit.shape[-1]
    alpha = evidence_fn(logit, evidence) + 1.0
    return k / alpha.sum(dim=-1)


def dirichlet_expected_prob(logit: torch.Tensor, evidence: str = 'exp'
                            ) -> torch.Tensor:
    """Expected class probability alpha / sum(alpha)."""
    alpha = evidence_fn(logit, evidence) + 1.0
    return alpha / alpha.sum(dim=-1, keepdim=True)


class I3DBackbone(nn.Module):
    """Holder that gives the backbone the reference's 'backbone._model'
    key prefix."""

    def __init__(self, **kw):
        super().__init__()
        self._model = InceptionI3d(**kw)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self._model(x)


class BDNet(nn.Module):
    """Boundary detection network for (open-set) TAL.

    `arch` picks the pyramid: 'thumos' (`CoarsePyramid`) or 'anet'
    (`AnetCoarsePyramid`, 768-frame clips, priors (P, 2); it has no
    dropout, as the JAX package's).

    `crop_size` fixes the spatial kernel of the pyramid's input convs
    (the JAX package derives it from the input at init). `dtype` is the
    compute dtype of the convolutions (None = float32); parameters stay
    float32. `freeze_bn` / `freeze_bn_affine` are the reference's BN
    freeze modes; `dropout` acts on the class heads' inputs in train mode.
    `stem_pallas` runs the I3D stem through the stem-pack kernel
    (`model.stem_pallas`; the same weights and math either way).
    `use_rpl` gives the THUMOS pyramid reciprocal-point class heads
    (`model.use_rpl`, the RPL / GCPL baselines).
    """

    def __init__(self, in_channels: int = 3, num_classes: int = 16,
                 os_head: bool = False, use_edl: bool = False,
                 evidence: str = 'exp', frame_num: int = 256,
                 crop_size: int = 96, freeze_bn: bool = True,
                 freeze_bn_affine: bool = True, dropout: float = 0.0,
                 stem_pallas: bool = False, arch: str = 'thumos',
                 use_rpl: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if arch not in ('thumos', 'anet'):
            raise ValueError(f'arch {arch!r}')
        if use_rpl and arch != 'thumos':
            raise ValueError('use_rpl needs the THUMOS pyramid')
        self.arch = arch
        self.use_rpl = use_rpl
        self.in_channels = in_channels
        self.num_classes = num_classes
        self.os_head = os_head
        self.use_edl = use_edl
        self.evidence = evidence
        self.frame_num = frame_num
        self.crop_size = crop_size
        self.dtype = dtype
        self.freeze_bn = freeze_bn
        self.backbone = I3DBackbone(in_channels=in_channels,
                                    freeze_bn=freeze_bn,
                                    freeze_bn_affine=freeze_bn_affine,
                                    stem_pallas=stem_pallas, dtype=dtype)
        if arch == 'anet':
            self.coarse_pyramid_detection = AnetCoarsePyramid(
                num_classes=self.head_classes, frame_num=frame_num,
                crop_size=crop_size, os_head=os_head, dtype=dtype)
        else:
            self.coarse_pyramid_detection = CoarsePyramid(
                num_classes=self.head_classes, frame_num=frame_num,
                crop_size=crop_size, os_head=os_head, dropout=dropout,
                use_rpl=use_rpl, dtype=dtype)

    @property
    def head_classes(self) -> int:
        # os_head drops the background channel (thumos14/BDNet.py:440)
        return self.num_classes - 1 if self.os_head else self.num_classes

    def forward(self, x: torch.Tensor, get_feat: bool = False
                ) -> Dict[str, Any]:
        return self.detect_from_features(self.backbone(x),
                                         get_feat=get_feat)

    def backbone_features(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The backbone alone: {'Mixed_4f', 'Mixed_5c'} of x. The
        shared-backbone inference runs it once over a span of several
        overlapping windows."""
        return self.backbone(x)

    def detect_from_features(self, feat_dict: Dict[str, torch.Tensor],
                             get_feat: bool = False) -> Dict[str, Any]:
        """The pyramid and heads on backbone features: the rest of the
        forward, with the same out_dict."""
        out = self.coarse_pyramid_detection(feat_dict, get_feat=get_feat)
        if self.use_edl:
            out['unct'] = dirichlet_uncertainty(out['conf'], self.evidence)
            out['prop_unct'] = dirichlet_uncertainty(out['prop_conf'],
                                                     self.evidence)
        if get_feat:
            out['conf_feat'] = out['ctr_feat']
            out['prop_conf_feat'] = out['prop_ctr_feat']
        return out

    def ssl_forward(self, x: torch.Tensor, proposals: torch.Tensor
                    ) -> Tuple[List[torch.Tensor], List[torch.Tensor],
                               List[torch.Tensor]]:
        """Boundary-contrastive features for the SSL triplet loss
        (thumos14/BDNet.py:479-503). proposals: (B, 3, 2) cut-paste
        segments in frame units. Returns per-scale (anchor, positive,
        negative) lists of (B, C/2) features."""
        trip = self.coarse_pyramid_detection(self.backbone(x),
                                             ssl=True)['trip']
        return self._ssl_triplets(trip, proposals)

    @staticmethod
    def _ssl_triplets(trip: List[torch.Tensor], proposals: torch.Tensor
                      ) -> Tuple[List[torch.Tensor], List[torch.Tensor],
                                 List[torch.Tensor]]:
        decoded = proposals[..., :2].float()                # (B, 3, 2)
        frame_segments = expand_boundary_segments(
            decoded[..., :1], decoded[..., 1:], plus_one=True)
        frame, loc_lr, conf_lr = trip
        k = frame_segments.shape[1]
        # the frame-level pool, and both lr pools as one segmented call
        # (loc_lr and conf_lr packed along t, each window on its own rows)
        bounds = [boundary_max_pool_segmented(
            frame.contiguous(), frame_segments / SSL_SCALES[0], None)]
        lr = boundary_max_pool_segmented(
            torch.cat([loc_lr, conf_lr], dim=1),
            torch.cat([frame_segments / SSL_SCALES[1],
                       frame_segments / SSL_SCALES[2]], dim=1),
            ((loc_lr.shape[1], k), (conf_lr.shape[1], k)))
        bounds += [lr[:, :k], lr[:, k:]]
        anchor, positive, negative = [], [], []
        for bound in bounds:                                # (B, 3, C)
            ndim = bound.shape[-1] // 2
            anchor.append(bound[:, 0, ndim:])
            positive.append(bound[:, 1, :ndim])
            negative.append(bound[:, 2, :ndim])
        return anchor, positive, negative
