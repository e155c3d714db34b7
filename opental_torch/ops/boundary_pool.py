"""Boundary max pooling: plain PyTorch version and dispatch.

Contract (the JAX package's, `opental_tpu/ops/boundary_pool.py`):
x (B, T, C), segments (B, K, 4) float, out (B, K, C) with

    out[b, k, c] = max over t in [l, r] of x[b, t, c]

where channel half h = c // (C/2) reads (l, r) from segments[b, k,
2h:2h+2], truncated toward zero, clamped to [0, T-1], and r = max(r, l)
(reference AFSD/prop_pooling/boundary_max_pooling_kernel.cu:17-46). The
gradient flows to the FIRST argmax of each window.

`boundary_max_pool` is the op the model calls: a CPU tensor goes to the
plain version, a CUDA tensor to the hand-written kernels
(`boundary_pool_cuda`: the forward, and when x needs a gradient the
forward that also writes the argmax plus the backward) or a raise.
`force_plain` exists for the tests and chip_smoke.py only, to hold the
kernels against the plain version on the card.
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import torch

from opental_torch.ops import boundary_pool_cuda


def clamp_windows(segments: torch.Tensor, t_len: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, K, 4) float segments -> int32 (l, r), each (B, K, 2) with the
    half on the last axis: trunc toward zero, clamp to [0, T-1], r >= l."""
    seg = segments.to(torch.int32)
    l = seg[..., 0::2].clamp(0, t_len - 1)
    r = seg[..., 1::2].clamp(0, t_len - 1)
    return l, torch.maximum(r, l)


def _plain_forward(x: torch.Tensor, segments: torch.Tensor,
                   with_argmax: bool):
    b, t_len, c = x.shape
    if c % 2:
        raise ValueError('channel count must split into start/end halves')
    half = c // 2
    l, r = clamp_windows(segments, t_len)
    pos = torch.arange(t_len, device=x.device, dtype=torch.int32)
    outs, args = [], []
    for h in range(2):
        mask = ((pos >= l[..., h, None])
                & (pos <= r[..., h, None]))[..., None]       # (B, K, T, 1)
        xh = x[:, None, :, h * half:(h + 1) * half]          # (B, 1, T, Ch)
        masked = torch.where(mask, xh, float('-inf'))        # (B, K, T, Ch)
        v = masked.amax(dim=2)
        outs.append(v)
        if with_argmax:
            hit = mask & (masked == v[:, :, None])
            tpos = pos.view(1, 1, t_len, 1).to(torch.int64)
            args.append(torch.where(hit, tpos, t_len).amin(dim=2))
    out = torch.cat(outs, -1)
    return out, (torch.cat(args, -1) if with_argmax else None)


class _PlainPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, segments):
        out, argmax = _plain_forward(x, segments, x.requires_grad)
        ctx.t_len = x.shape[1]
        ctx.save_for_backward(argmax if argmax is not None
                              else torch.empty(0))
        return out

    @staticmethod
    def backward(ctx, g):
        (argmax,) = ctx.saved_tensors
        return plain_backward(argmax, g, ctx.t_len), None


def plain_backward(argmax: torch.Tensor, g: torch.Tensor, t_len: int
                   ) -> torch.Tensor:
    """dx (B, T, C) in g's dtype: each g[b, k, c] added at its first
    argmax, summed in float32 in ascending k and rounded once, the
    kernel's order (one scatter per k, so no two adds of a scatter meet)."""
    b, k_num, c = argmax.shape
    dx = torch.zeros((b, t_len, c), dtype=torch.float32, device=g.device)
    idx, src = argmax.long(), g.float()
    for k in range(k_num):
        dx.scatter_add_(1, idx[:, k:k + 1], src[:, k:k + 1])
    return dx.to(g.dtype)


def boundary_max_pool_plain(x: torch.Tensor, segments: torch.Tensor
                            ) -> torch.Tensor:
    """Mask-and-max version, differentiable in x (first-argmax
    backward). O(B*K*T*C) memory."""
    return _PlainPool.apply(x, segments)


class _CudaPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, segments):
        train = ctx.needs_input_grad[0]
        out, argmax = boundary_pool_cuda.boundary_max_pool_fwd(
            x, segments, with_argmax=train)
        if train:
            ctx.t_len = x.shape[1]
            ctx.save_for_backward(argmax)
        return out

    @staticmethod
    def backward(ctx, g):
        (argmax,) = ctx.saved_tensors
        return boundary_pool_cuda.boundary_max_pool_bwd(
            argmax, g.contiguous(), ctx.t_len), None


_FORCE_PLAIN = False


@contextlib.contextmanager
def force_plain():
    """Route CUDA tensors to the plain version (tests and chip_smoke.py
    only; the main path never uses this)."""
    global _FORCE_PLAIN
    prev, _FORCE_PLAIN = _FORCE_PLAIN, True
    try:
        yield
    finally:
        _FORCE_PLAIN = prev


def boundary_max_pool(x: torch.Tensor, segments: torch.Tensor
                      ) -> torch.Tensor:
    """The op the model calls: kernel on a CUDA tensor, plain version on a
    CPU tensor."""
    if x.is_cuda and not _FORCE_PLAIN:
        return _CudaPool.apply(x, segments)
    return boundary_max_pool_plain(x, segments)
