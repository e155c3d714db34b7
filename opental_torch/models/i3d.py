"""Inception-v1 I3D backbone up to Mixed_5c (PyTorch, (B, C, T, H, W)).

Counterpart of `opental_tpu/models/i3d.py`; reference
AFSD/common/i3d_backbone.py:90-342. Endpoint and branch names match the
public I3D checkpoint keys ('Conv3d_1a_7x7.conv3d.weight',
'Mixed_3b.b1b.bn.running_var', ...). The stem is a plain stride-2 Conv3d
with TF-SAME pads, or with `stem_pallas` the JAX package's packed
space-to-depth stem (`model.stem_pallas`: the stem-pack kernel and one 2D
convolution, `models/layers.space_to_depth_conv3d`) on the same weight.
The JAX package's XLA space-to-depth (pack24 + conv3d), temporal-fold and
decomposed variants are TPU layouts of the same math and are not ported.
`remat` recomputes each block (the stem, each Unit3D, each
InceptionModule) in the backward instead of keeping its activations
(`model.remat`, `opental_tpu/models/i3d.py:135-160`). Each endpoint's
forward is the span `model.backbone.<endpoint>` (`utils/profiling`).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from opental_torch.models.layers import (Unit3D, bn_recompute,
                                         max_pool_3d_same)
from opental_torch.utils import profiling

# branch output channels per inception module (i3d_backbone.py:229-295)
INCEPTION_SPECS: Dict[str, Sequence[int]] = {
    'Mixed_3b': (64, 96, 128, 16, 32, 32),
    'Mixed_3c': (128, 128, 192, 32, 96, 64),
    'Mixed_4b': (192, 96, 208, 16, 48, 64),
    'Mixed_4c': (160, 112, 224, 24, 64, 64),
    'Mixed_4d': (128, 128, 256, 24, 64, 64),
    'Mixed_4e': (112, 144, 288, 32, 64, 64),
    'Mixed_4f': (256, 160, 320, 32, 128, 128),
    'Mixed_5b': (256, 160, 320, 32, 128, 128),
    'Mixed_5c': (384, 192, 384, 48, 128, 128),
}

ENDPOINTS: Tuple[str, ...] = (
    'Conv3d_1a_7x7', 'MaxPool3d_2a_3x3', 'Conv3d_2b_1x1', 'Conv3d_2c_3x3',
    'MaxPool3d_3a_3x3', 'Mixed_3b', 'Mixed_3c', 'MaxPool3d_4a_3x3',
    'Mixed_4b', 'Mixed_4c', 'Mixed_4d', 'Mixed_4e', 'Mixed_4f',
    'MaxPool3d_5a_2x2', 'Mixed_5b', 'Mixed_5c',
)

BLOCK_SPANS = {ep: 'model.backbone.' + ep for ep in ENDPOINTS}

# (x shape, kernel, stride) of one max_pool_3d_same call
PoolCall = Tuple[Tuple[int, ...], Tuple[int, int, int], Tuple[int, int, int]]

MAXPOOL_SPECS = {
    'MaxPool3d_2a_3x3': ((1, 3, 3), (1, 2, 2)),
    'MaxPool3d_3a_3x3': ((1, 3, 3), (1, 2, 2)),
    'MaxPool3d_4a_3x3': ((3, 3, 3), (2, 2, 2)),
    'MaxPool3d_5a_2x2': ((2, 2, 2), (2, 2, 2)),
}


class InceptionModule(nn.Module):
    """4-branch inception block (i3d_backbone.py:90-121)."""

    def __init__(self, in_channels: int, out_channels: Sequence[int],
                 bn_freeze_affine: bool = True, bn_freeze_stats: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        oc = out_channels
        kw = dict(bn_freeze_affine=bn_freeze_affine,
                  bn_freeze_stats=bn_freeze_stats, dtype=dtype)
        self.b0 = Unit3D(in_channels, oc[0], (1, 1, 1), **kw)
        self.b1a = Unit3D(in_channels, oc[1], (1, 1, 1), **kw)
        self.b1b = Unit3D(oc[1], oc[2], (3, 3, 3), **kw)
        self.b2a = Unit3D(in_channels, oc[3], (1, 1, 1), **kw)
        self.b2b = Unit3D(oc[3], oc[4], (3, 3, 3), **kw)
        self.b3b = Unit3D(in_channels, oc[5], (1, 1, 1), **kw)
        self.out_channels = oc[0] + oc[2] + oc[4] + oc[5]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = max_pool_3d_same(x, (3, 3, 3), (1, 1, 1))
        return torch.cat([self.b0(x), self.b1b(self.b1a(x)),
                          self.b2b(self.b2a(x)), self.b3b(b3)], dim=1)


class InceptionI3d(nn.Module):
    """I3D feature extractor up to Mixed_5c. forward returns the two
    endpoints the pyramid consumes: {'Mixed_4f': (B, 832, T/4, H/16,
    W/16), 'Mixed_5c': (B, 1024, T/8, H/32, W/32)}."""

    KEEP = ('Mixed_4f', 'Mixed_5c')

    def __init__(self, in_channels: int = 3, freeze_bn: bool = True,
                 freeze_bn_affine: bool = True, stem_pallas: bool = False,
                 remat: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.remat = remat
        # reference freeze modes (thumos14/BDNet.py:39-49): freeze_bn keeps
        # the running statistics and the affine; freeze_bn: false trains
        # both, and freeze_bn_affine only acts with freeze_bn
        kw = dict(bn_freeze_stats=freeze_bn,
                  bn_freeze_affine=freeze_bn and freeze_bn_affine,
                  dtype=dtype)
        ch = in_channels
        for ep in ENDPOINTS:
            if ep == 'Conv3d_1a_7x7':
                mod = Unit3D(ch, 64, (7, 7, 7), (2, 2, 2),
                             space_to_depth=stem_pallas, **kw)
                ch = 64
            elif ep == 'Conv3d_2b_1x1':
                mod = Unit3D(ch, 64, (1, 1, 1), **kw)
            elif ep == 'Conv3d_2c_3x3':
                mod = Unit3D(ch, 192, (3, 3, 3), **kw)
                ch = 192
            elif ep in MAXPOOL_SPECS:
                continue
            else:
                mod = InceptionModule(ch, INCEPTION_SPECS[ep], **kw)
                ch = mod.out_channels
            self.add_module(ep, mod)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        for ep in ENDPOINTS:
            with profiling.span(BLOCK_SPANS[ep]):
                if ep in MAXPOOL_SPECS:
                    x = max_pool_3d_same(x, *MAXPOOL_SPECS[ep])
                elif self.remat and torch.is_grad_enabled():
                    # the recompute leaves BN's running statistics as the
                    # first pass left them (`bn_recompute`), as JAX's
                    # functional nn.remat does
                    x = checkpoint(getattr(self, ep), x,
                                   use_reentrant=False,
                                   context_fn=bn_recompute)
                else:
                    x = getattr(self, ep)(x)
            if ep in self.KEEP:
                out[ep] = x
        return out


def pool_calls(windows: int, frames: int, crop: int,
               in_channels: int = 3) -> List[PoolCall]:
    """(x shape, kernel, stride) of each 3D max-pool call of one forward
    of `windows` clips of `frames` x `crop` x `crop`, in call order (13:
    four endpoint pools and one branch pool a module), from a forward on
    the meta device."""
    global max_pool_3d_same
    calls: List[PoolCall] = []
    real = max_pool_3d_same

    def recording(x, kernel, stride):
        calls.append((tuple(x.shape), tuple(kernel), tuple(stride)))
        return real(x, kernel, stride)

    model = InceptionI3d(in_channels).to('meta')
    max_pool_3d_same = recording
    try:
        with torch.no_grad():
            model(torch.empty(windows, in_channels, frames, crop, crop,
                              device='meta'))
    finally:
        max_pool_3d_same = real
    return calls
