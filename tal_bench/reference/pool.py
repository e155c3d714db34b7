"""Boundary max pooling, plain PyTorch only (no kernel).

A frozen copy of the port's plain version. Contract: x (B, T, C),
segments (B, K, 4) float, out (B, K, C) with

    out[b, k, c] = max over t in [l, r] of x[b, t, c]

where channel half h = c // (C/2) reads (l, r) from segments[b, k,
2h:2h+2], truncated toward zero, clamped to [0, T-1], and r = max(r, l)
(AFSD/prop_pooling/boundary_max_pooling_kernel.cu:17-46). The gradient
flows to the first argmax of each window. `levels` ((t_i, k_i), ...)
packs several such problems along T and K; window k of level i reads
only that level's rows.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

Levels = Tuple[Tuple[int, int], ...]


def check_levels(levels: Optional[Sequence[Tuple[int, int]]], t_total: int,
                 k_total: int) -> Levels:
    """The level table as int pairs; None is one level (T, K)."""
    if levels is None:
        levels = ((t_total, k_total),)
    levels = tuple((int(t), int(k)) for t, k in levels)
    if (sum(t for t, _ in levels), sum(k for _, k in levels)) != \
            (t_total, k_total):
        raise ValueError(f'levels {levels} do not sum to T = {t_total}, '
                         f'K = {k_total}')
    return levels


def clamp_windows(segments: torch.Tensor, t_len: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, K, 4) float segments -> int32 (l, r), each (B, K, 2) with the
    half on the last axis: trunc toward zero, clamp to [0, T-1], r >= l.
    The conversion saturates at the int32 range and takes NaN to 0, as
    the kernel's __float2int_rz and the JAX op's astype(int32) do (a bare
    float -> int32 cast is undefined out of range, and on x86 CPUs gives
    INT32_MIN for +1e10 and +inf)."""
    seg = torch.nan_to_num(segments, nan=0.0).clamp(
        -2147483648.0, 2147483520.0).to(torch.int32)
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


def _level_slices(levels: Levels):
    """(rows, windows) slices of each level on the packed axes."""
    x_off = k_off = 0
    for t, k in levels:
        yield slice(x_off, x_off + t), slice(k_off, k_off + k)
        x_off, k_off = x_off + t, k_off + k


def plain_forward_segmented(x: torch.Tensor, segments: torch.Tensor,
                            levels: Levels, with_argmax: bool):
    """The segmented contract as a loop over levels of `_plain_forward`
    on each level's slices, the argmax offset onto the packed T axis."""
    outs, args = [], []
    for rows, wins in _level_slices(levels):
        if wins.stop == wins.start:
            continue
        out, argmax = _plain_forward(x[:, rows], segments[:, wins],
                                     with_argmax)
        outs.append(out)
        if with_argmax:
            args.append(argmax + rows.start)
    if not outs:
        empty = x.new_empty((x.shape[0], 0, x.shape[2]))
        return empty, (empty.long() if with_argmax else None)
    return (torch.cat(outs, 1),
            torch.cat(args, 1) if with_argmax else None)


def plain_backward_segmented(argmax: torch.Tensor, g: torch.Tensor,
                             levels: Levels) -> torch.Tensor:
    """dx (B, T, C) of the segmented contract: `plain_backward` on each
    level's slices of the packed argmax and g, concatenated."""
    return torch.cat([plain_backward(argmax[:, wins] - rows.start,
                                     g[:, wins], rows.stop - rows.start)
                      for rows, wins in _level_slices(levels)], 1)


class _PlainPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, segments, levels):
        out, argmax = plain_forward_segmented(x, segments, levels,
                                              x.requires_grad)
        ctx.levels = levels
        ctx.save_for_backward(argmax if argmax is not None
                              else torch.empty(0))
        return out

    @staticmethod
    def backward(ctx, g):
        (argmax,) = ctx.saved_tensors
        return plain_backward_segmented(argmax, g, ctx.levels), None, None


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


def boundary_max_pool_segmented(x: torch.Tensor, segments: torch.Tensor,
                                levels: Optional[Sequence[Tuple[int, int]]]
                                ) -> torch.Tensor:
    """The segmented op, differentiable in x."""
    return _PlainPool.apply(x, segments,
                            check_levels(levels, x.shape[1],
                                         segments.shape[1]))
