"""Layer library of the port (PyTorch, channels-first).

Counterpart of `opental_tpu/models/layers.py`. Video tensors are
(B, C, T, H, W) and temporal features (B, C, T), as in the reference
torch code, and module/parameter names follow the reference state_dict
(`conv3d`, `conv1d`, `bn`), so a reference checkpoint loads as it is.

Numerics follow the JAX package:
* TF-SAME padding puts the odd pad at the end (front = total // 2); it is
  applied with F.pad and the convolution runs unpadded;
* convolutions run in the compute dtype (`dtype`, None = float32): input,
  weight and bias are cast to it;
* GroupNorm computes and returns float32 whatever its input dtype, as
  flax's GroupNorm without a dtype does;
* BatchNorm folds its statistics (running, or the batch's in train mode
  with freeze_stats off) into one scale and bias, cast to the input
  dtype: y = x * scale + bias.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from opental_torch.ops import stem_pack

GN_EPS = 1e-5   # torch GroupNorm default (reference nn.GroupNorm(32, C))
BN_EPS = 1e-3   # reference BatchNorm3d(eps=0.001) in the I3D backbone


def _to_tuple(x, n: int) -> Tuple[int, ...]:
    if isinstance(x, (tuple, list)):
        assert len(x) == n
        return tuple(x)
    return (x,) * n


def same_pad_amount(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """TF-SAME pad split (front = total // 2)."""
    if size % stride == 0:
        total = max(kernel - stride, 0)
    else:
        total = max(kernel - (size % stride), 0)
    return total // 2, total - total // 2


def _f_pad(sizes: Sequence[int], kernel: Sequence[int],
           stride: Sequence[int]) -> Tuple[int, ...]:
    """F.pad argument (last dim first) for SAME padding of trailing dims."""
    pads: Tuple[int, ...] = ()
    for size, k, s in reversed(list(zip(sizes, kernel, stride))):
        pads += same_pad_amount(size, k, s)
    return pads


class FrozenBatchNorm(nn.Module):
    """BatchNorm over dim 1 in every reference freeze mode
    (thumos14/BDNet.py:39-49; `opental_tpu/models/layers.py:45-104`).

    freeze_affine=True keeps weight/bias as buffers (the shipped configs'
    freeze_bn_affine), False as parameters. freeze_stats=True (the shipped
    freeze_bn) always normalizes by the running statistics. With
    freeze_stats=False a module in train mode (`.train()`) normalizes by
    the biased batch statistics, taken in float32 in the centered two-pass
    form, and EMA-updates the running statistics in place with the
    unbiased batch variance (momentum 0.01, torch BatchNorm's train mode);
    in eval mode it uses the running statistics.
    """

    def __init__(self, features: int, eps: float = BN_EPS,
                 freeze_affine: bool = True, freeze_stats: bool = True,
                 momentum: float = 0.01):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.freeze_stats = freeze_stats
        if freeze_affine:
            self.register_buffer('weight', torch.ones(features))
            self.register_buffer('bias', torch.zeros(features))
        else:
            self.weight = nn.Parameter(torch.ones(features))
            self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer('running_mean', torch.zeros(features))
        self.register_buffer('running_var', torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and not self.freeze_stats:
            xf = x.float()
            axes = (0,) + tuple(range(2, x.dim()))
            mean = xf.mean(dim=axes)
            # centered two-pass variance: E[x^2] - E[x]^2 cancels for
            # large-mean activations and can go negative; this cannot
            shape = (1, -1) + (1,) * (x.dim() - 2)
            var = (xf - mean.view(shape)).square().mean(dim=axes).clamp_min(
                0.0)
            n = x.numel() // x.shape[1]
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1 - m).add_(m * mean.detach())
                self.running_var.mul_(1 - m).add_(
                    m * (var.detach() * (n / max(n - 1, 1))))
        else:
            mean = self.running_mean.float()
            var = self.running_var.float()
        inv = torch.rsqrt(var + self.eps)
        gamma = self.weight.float()
        shape = (1, -1) + (1,) * (x.dim() - 2)
        scale = (gamma * inv).to(x.dtype).view(shape)
        bias = (self.bias.float() - mean * gamma * inv).to(x.dtype).view(
            shape)
        return x * scale + bias


def _cast(x: torch.Tensor, dtype) -> torch.Tensor:
    return x if dtype is None or x.dtype == dtype else x.to(dtype)


def space_to_depth_pad(x: torch.Tensor, kernel: Sequence[int]
                       ) -> torch.Tensor:
    """x (B, C, T, H, W) TF-SAME padded for a stride-2 conv, with one more
    trailing zero where the padded extent would be odd (it meets only the
    zero taps of the packed weight), as `opental_tpu/models/layers.py:
    311-321` pads: the stem pack's input xp (B, Tp, Hp, Wp, C), a permuted
    view of the padded tensor."""
    pads: Tuple[int, ...] = ()
    for size, k in reversed(list(zip(x.shape[2:], kernel))):
        total = max(k - 2, 0) if size % 2 == 0 else max(k - 1, 0)
        lo = total // 2
        pads += (lo, total - lo + (size + total) % 2)
    return F.pad(x, pads).permute(0, 2, 3, 4, 1)


def space_to_depth_conv3d(x: torch.Tensor, weight: torch.Tensor,
                          dtype: Optional[torch.dtype] = None
                          ) -> torch.Tensor:
    """The stride-2 TF-SAME Conv3d of x (B, C, T, H, W) with weight (F, C,
    kt, kh, kw), computed as the JAX package's `SpaceToDepthConv3d(
    use_pallas=True)` does it (`opental_tpu/models/layers.py:298-324`):
    cast to the compute dtype, pad (`space_to_depth_pad`), then pack and
    convolve. The layout is the faster one on the H100 (chip_smoke.py
    phase 11, PERF.md): without a weight gradient the channel-leading v2
    pack and an NCHW conv (`ops/stem_pack.stem_conv_v2`, as the JAX model
    calls it); when the weight takes a gradient, the channels-last v1 pack
    (`stem_conv_v1`), whose weight gradient needs no transpose of z."""
    x = _cast(x, dtype)
    xp = space_to_depth_pad(x, weight.shape[2:])
    w = _cast(weight, x.dtype)
    if torch.is_grad_enabled() and w.requires_grad:
        return stem_pack.stem_conv_v1(xp, w)
    return stem_pack.stem_conv_v2(xp, w)


class Unit3D(nn.Module):
    """Conv3d + optional frozen BN + optional ReLU, TF-SAME padded.

    padding: 'same', or 'spatial_valid' (time SAME, space unpadded: the
    pyramid's input convs). The I3D stem is this module with kernel 7 and
    stride 2, either as a plain strided Conv3d or, with space_to_depth,
    through `space_to_depth_conv3d` (the stem-pack kernel and one 2D
    convolution): the same math and the same `conv3d.weight`.
    """

    def __init__(self, in_channels: int, features: int,
                 kernel: Sequence[int] = (1, 1, 1),
                 stride: Sequence[int] = (1, 1, 1), padding: str = 'same',
                 use_bias: bool = False, use_batch_norm: bool = True,
                 activation: bool = True, bn_freeze_affine: bool = True,
                 bn_freeze_stats: bool = True,
                 dtype: Optional[torch.dtype] = None,
                 space_to_depth: bool = False):
        super().__init__()
        self.kernel = _to_tuple(kernel, 3)
        self.stride = _to_tuple(stride, 3)
        if padding not in ('same', 'spatial_valid'):
            raise ValueError(padding)
        if space_to_depth and (self.stride != (2, 2, 2) or use_bias
                               or padding != 'same'):
            raise ValueError('space_to_depth takes a stride-2 SAME conv '
                             'without bias')
        self.space_to_depth = space_to_depth
        self.padding = padding
        self.activation = activation
        self.dtype = dtype
        self.conv3d = nn.Conv3d(in_channels, features, self.kernel,
                                stride=self.stride, padding=0,
                                bias=use_bias)
        self.bn = (FrozenBatchNorm(features, freeze_affine=bn_freeze_affine,
                                   freeze_stats=bn_freeze_stats)
                   if use_batch_norm else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.space_to_depth:
            x = space_to_depth_conv3d(x, self.conv3d.weight, self.dtype)
        else:
            x = self._conv(x)
        if self.bn is not None:
            x = self.bn(x)
        if self.activation:
            x = torch.relu(x)
        return x

    def _conv(self, x: torch.Tensor) -> torch.Tensor:
        t, h, w = x.shape[2:]
        if self.padding == 'same':
            pads = _f_pad((t, h, w), self.kernel, self.stride)
        else:
            pads = (0, 0, 0, 0) + same_pad_amount(t, self.kernel[0],
                                                  self.stride[0])
        x = F.pad(_cast(x, self.dtype), pads)
        bias = self.conv3d.bias
        return F.conv3d(x, _cast(self.conv3d.weight, self.dtype),
                        None if bias is None else _cast(bias, self.dtype),
                        self.stride)


def max_pool_3d_same(x: torch.Tensor, kernel: Sequence[int],
                     stride: Sequence[int]) -> torch.Tensor:
    """Max-pool over (B, C, T, H, W) after a ZERO TF-SAME pad, as the
    reference does (AFSD/common/layers.py:9-35)."""
    kernel = _to_tuple(kernel, 3)
    stride = _to_tuple(stride, 3)
    x = F.pad(x, _f_pad(x.shape[2:], kernel, stride))
    return F.max_pool3d(x, kernel, stride)


class Unit1D(nn.Module):
    """Conv1d over (B, C, T), TF-SAME padded, + optional ReLU."""

    def __init__(self, in_channels: int, features: int, kernel: int = 1,
                 stride: int = 1, use_bias: bool = True,
                 activation: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.kernel, self.stride = kernel, stride
        self.activation = activation
        self.dtype = dtype
        self.conv1d = nn.Conv1d(in_channels, features, kernel, stride=stride,
                                padding=0, bias=use_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.pad(_cast(x, self.dtype),
                  same_pad_amount(x.shape[2], self.kernel, self.stride))
        bias = self.conv1d.bias
        x = F.conv1d(x, _cast(self.conv1d.weight, self.dtype),
                     None if bias is None else _cast(bias, self.dtype),
                     self.stride)
        return torch.relu(x) if self.activation else x


class GroupNorm32(nn.GroupNorm):
    """GroupNorm(32 groups, eps 1e-5) computed in, and returning, float32
    whatever the input dtype (flax GroupNorm without a dtype)."""

    def __init__(self, channels: int):
        super().__init__(32, channels, eps=GN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.weight,
                            self.bias, self.eps)


class ConvGNReLU1D(nn.Sequential):
    """Unit1D (no activation) -> GroupNorm(32) -> ReLU; children 0/1/2 as
    in the reference's nn.Sequential blocks (thumos14/BDNet.py:156-203)."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3,
                 stride: int = 1, dtype: Optional[torch.dtype] = None):
        super().__init__(
            Unit1D(in_channels, features, kernel, stride, activation=False,
                   dtype=dtype),
            GroupNorm32(features), nn.ReLU())


class ScaleExp(nn.Module):
    """exp(x * learnable scale) (thumos14/BDNet.py:55-61)."""

    def __init__(self, init_value: float = 1.0):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor([init_value]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.exp(x * self.scale.to(x.dtype))


class RPLHead(nn.Module):
    """Reciprocal-point distance head (reference layers.py:314-351): the
    squared l2 distance of each feature to every learned class center,
    over the feature width, averaged over a class's centers. Input
    (B, t, D) channels-last (the JAX package's layout); output (B, t, K),
    float32. The centers are (K * num_centers, D), key
    `conf_head.centers` / `prop_conf_head.centers` as the reference."""

    def __init__(self, num_classes: int, feat_dim: int,
                 num_centers: int = 1):
        super().__init__()
        self.num_classes, self.num_centers = num_classes, num_centers
        self.centers = nn.Parameter(
            0.1 * torch.randn(num_classes * num_centers, feat_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        c = self.centers
        f2 = (x * x).sum(dim=-1, keepdim=True)                # (B, t, 1)
        c2 = (c * c).sum(dim=-1)                              # (KC,)
        cross = torch.matmul(x, c.t())                        # (B, t, KC)
        dist = (f2 - 2.0 * cross + c2) / float(x.shape[-1])
        return dist.reshape(x.shape[0], x.shape[1], self.num_classes,
                            self.num_centers).mean(dim=-1)


def interpolate_nearest_1d(x: torch.Tensor, out_len: int) -> torch.Tensor:
    """Nearest resize of the last axis of (B, C, T), idx = floor(i*T/out)
    (F.interpolate(mode='nearest')'s rule)."""
    t = x.shape[-1]
    if out_len == t:
        return x
    if out_len % t == 0:
        return x.repeat_interleave(out_len // t, dim=-1)
    idx = (torch.arange(out_len, device=x.device) * t) // out_len
    return x.index_select(-1, idx)
