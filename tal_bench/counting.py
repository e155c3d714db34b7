"""The yardstick's arithmetic: the peaks of the card, the operations a
configuration's model needs, and the least bytes of a boundary-pool call.

Operations and bytes are the work the configuration and a call's inputs
need, whatever the implementation: the FLOPs come from the plain
reference model run on the meta device (no memory, no time) under a
counter of the convolutions and matrix products it issues; the byte
bounds are a frozen copy of the port's bring-up smoke script's
`pool_bound_ms` and `bwd_bound_ms` arithmetic.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# NVIDIA H100 SXM data sheet, dense, at its 700 W limit
PEAK_FLOPS = {'bf16': 989e12, 'tf32': 495e12, 'fp32': 67e12}
HBM_BYTES_PER_S = 3.35e12

_aten = torch.ops.aten


def _conv_flops(out_shape, w_shape, transposed: bool, in_shape) -> int:
    """2 * MACs of a convolution: each output element takes
    (C_in / groups) * prod(kernel) products (transposed: each input
    element)."""
    per = math.prod(w_shape[1:])
    n = math.prod(in_shape if transposed else out_shape)
    return 2 * n * per


class FlopCounter(TorchDispatchMode):
    """Counts convolution and matrix-product FLOPs of what runs inside
    it, forward and backward."""

    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        if packet is _aten.convolution:
            x, w = args[0], args[1]
            self.flops += _conv_flops(out.shape, w.shape, bool(args[6]),
                                      x.shape)
        elif packet is _aten.convolution_backward:
            grad, x, w = args[0], args[1], args[2]
            transposed, mask = bool(args[7]), args[10]
            one = _conv_flops(grad.shape, w.shape, transposed, x.shape)
            self.flops += one * (int(bool(mask[0])) + int(bool(mask[1])))
        elif packet in (_aten.mm, _aten.bmm):
            a, b = args[0], args[1]
            self.flops += 2 * math.prod(a.shape) * b.shape[-1]
        elif packet is _aten.addmm:
            a, b = args[1], args[2]
            self.flops += 2 * math.prod(a.shape) * b.shape[-1]
        return out


def model_flops(cfg: Dict[str, Any], frame_num: int, crop_size: int,
                batch: int, train: bool, ssl: bool = False) -> int:
    """FLOPs of the configuration's model for `batch` clips: one forward
    (train=False), or the training step's passes (the main pass and,
    with ssl, the SSL pass) forward and backward."""
    from tal_bench.reference import build
    with torch.device('meta'):
        model = build.model(cfg, frame_num, crop_size)
        x = torch.zeros((batch, model.in_channels, frame_num, crop_size,
                         crop_size))
    counter = FlopCounter()
    if not train:
        model.eval()
        with torch.no_grad(), counter:
            model(x)
        return counter.flops
    model.train()
    with counter:
        out = model(x)
        total = sum(v.float().sum() for k, v in out.items()
                    if isinstance(v, torch.Tensor) and v.requires_grad)
        if ssl:
            props = torch.zeros((batch, 3, 2), device='meta')
            trip = model.ssl_forward(x, props)
            total = total + sum(t.float().sum() for part in trip
                                for t in part)
        total.backward()
    return counter.flops


# ------------------------------------------------------------- pool bytes

def _clamp_windows(segments: torch.Tensor, t_len: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    seg = torch.nan_to_num(segments, nan=0.0).clamp(
        -2147483648.0, 2147483520.0).to(torch.int32)
    lo = seg[..., 0::2].clamp(0, t_len - 1)
    hi = seg[..., 1::2].clamp(0, t_len - 1)
    return lo, torch.maximum(hi, lo)


def pool_fwd_bytes(x_shape: Sequence[int], x_itemsize: int,
                   segments: torch.Tensor,
                   levels: Optional[Sequence[Tuple[int, int]]],
                   with_argmax: bool) -> int:
    """Least bytes of one boundary-pool forward: every x row that a
    window of its level covers, read once per channel half; the
    segments; the output (and the int32 argmax) written once."""
    b, t_len, c = x_shape
    k_total = segments.shape[1]
    if levels is None:
        levels = ((t_len, k_total),)
    rows, k_off = 0, 0
    for t, k in levels:
        if k:
            lo, hi = _clamp_windows(segments[:, k_off:k_off + k].float(), t)
            pos = torch.arange(t, device=segments.device)
            cover = ((pos >= lo[..., None]) & (pos <= hi[..., None])).any(
                dim=1)                                    # (b, half, t)
            rows += int(cover.sum())
        k_off += k
    out_bytes = x_itemsize + (4 if with_argmax else 0)
    return (rows * (c // 2) * x_itemsize + segments.numel() * 4
            + b * k_total * c * out_bytes)


def pool_bwd_bytes(g_shape: Sequence[int], g_itemsize: int, t_len: int
                   ) -> int:
    """Least bytes of one boundary-pool backward: g and the int32 argmax
    read once, dx written once."""
    b, k, c = g_shape
    return b * k * c * (g_itemsize + 4) + b * t_len * c * g_itemsize


def least_seconds(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S


def pool_roofline_pct(calls, durations, backward: bool) -> Optional[float]:
    """The least time of the captured boundary-pool calls over the
    device time of the kernels they launched (one each, matched in
    order), in %. None where there is nothing to read or the counts do
    not match."""
    if not calls or len(calls) > len(durations):
        return None
    least = 0.0
    for c in calls:
        if backward:
            nbytes = pool_bwd_bytes(c['g_shape'], c['itemsize'], c['t_len'])
        else:
            nbytes = pool_fwd_bytes(c['x_shape'], c['itemsize'],
                                    c['segments'], c['levels'],
                                    c['with_argmax'])
        least += least_seconds(nbytes)
    spent = sum(durations[:len(calls)])
    return 100.0 * least / spent if spent > 0 else None


def mfu_pct(units: int, flops_per_unit: int, window_s: float, peak: str
            ) -> Optional[float]:
    """The model's FLOPs for the units completed over the window, over
    the card's peak in that precision, in %."""
    if not units or window_s <= 0:
        return None
    return 100.0 * units * flops_per_unit / window_s / PEAK_FLOPS[peak]
