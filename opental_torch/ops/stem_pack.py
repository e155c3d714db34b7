"""Space-to-depth packing of the I3D stem: plain PyTorch versions,
dispatch, and the packed stem convolution.

Contract (the JAX package's, `opental_tpu/ops/stem_pack_pallas.py`): xp
(B, Tp, Hp, Wp, C) is the padded video (Tp, Hp, Wp even) and

    z[b, u, p, q, ch] = xp[b, 2u + r, 2p + bi, 2q + bj, c],
    ch = ((r * 2 + bi) * 2 + bj) * C + c,  r = 2 at + bt in [0, 2 a_t),

for u < t_out = Tp/2 - a_t + 1: a 2x2x2 space-to-depth with a_t
temporal taps, 8 a_t C channels (96 for RGB at a_t = 4). Two layouts of
that one tensor:

* v1, `stem_pack96`: channels-last, (B, t_out, Hp/2, Wp/2, 96);
* v2, `stem_pack96_v2`: channel-leading, (B, t_out/fp, 96, Hp/2,
  fp Wp/2), with fp consecutive output frames side by side on the last
  axis: z2[b, v, ch, p, s Wp/2 + q] = z[b, fp v + s, p, q, ch].

The JAX v2 kernel reads `host_prelayout`'s copy of xp, which pads H to a
multiple of 8 and the lanes to 128 for the TPU's DMA tiling; that padding
is no part of the function, and the port has none (its z equals JAX's on
the first Hp/2 rows). The public functions take xp in the JAX layout, and
accept a permuted view of the model's (B, C, Tp, Hp, Wp) tensor as it
is: the kernel reads through the strides it is given.

`stem_pack_strided` is the same function as one strided copy, the
library yardstick that chip_smoke.py times beside the kernel.

`stem_pack96` / `stem_pack96_v2` are the ops the model calls: a CPU
tensor goes to the plain version, a CUDA tensor to the hand-written
kernel through its custom op (`stem_pack_cuda`) or a raise. `force_plain` exists for the tests
and chip_smoke.py only. `stem_conv_v2` / `stem_conv_v1` are the whole
stride-2 7x7x7 stem convolution as one pack and one 4x4 VALID 2D
convolution with `pack96_weights`, the same math as the plain strided
Conv3d on the same weights.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from opental_torch.ops import stem_pack_cuda


def pack_shape(xp: torch.Tensor, a_t: int):
    """(b, t_out, h2, wq, c) of the pack of xp (B, Tp, Hp, Wp, C); raises
    on odd or too short extents."""
    if xp.dim() != 5:
        raise ValueError(f'xp must be (B, Tp, Hp, Wp, C), got '
                         f'{tuple(xp.shape)}')
    b, tp, hp, wp, c = xp.shape
    if tp % 2 or hp % 2 or wp % 2:
        raise ValueError(f'Tp, Hp, Wp must be even, got {(tp, hp, wp)}')
    t_out = tp // 2 - a_t + 1
    if a_t < 1 or t_out < 1:
        raise ValueError(f'Tp {tp} is too short for a_t {a_t}')
    return b, t_out, hp // 2, wp // 2, c


def stem_pack96_plain(xp: torch.Tensor, a_t: int = 4) -> torch.Tensor:
    """v1 as staged reshapes (the counterpart of `stem_pack96_xla`)."""
    b, t_out, h2, wq, c = pack_shape(xp, a_t)
    y = xp.reshape(b, t_out + a_t - 1, 2, h2, 2, wq, 2, c)
    z = torch.stack([y[:, at:at + t_out] for at in range(a_t)], 2)
    # (b, u, at, bt, p, bi, q, bj, c) -> (b, u, p, q, at, bt, bi, bj, c)
    z = z.permute(0, 1, 4, 6, 2, 3, 5, 7, 8)
    return z.reshape(b, t_out, h2, wq, 8 * a_t * c)


def stem_pack96_v2_plain(xp: torch.Tensor, a_t: int = 4, fp: int = 1
                         ) -> torch.Tensor:
    """v2: the v1 tensor laid out channel-leading, fp frames a row."""
    z = stem_pack96_plain(xp, a_t)
    b, t_out, h2, wq, ch = z.shape
    if fp < 1 or t_out % fp:
        raise ValueError(f't_out {t_out} does not split into fp {fp}')
    z = z.reshape(b, t_out // fp, fp, h2, wq, ch).permute(0, 1, 5, 3, 2, 4)
    return z.reshape(b, t_out // fp, ch, h2, fp * wq)


def stem_pack_strided(xp: torch.Tensor, a_t: int = 4, fp: int = 1,
                      layout: str = 'v2') -> torch.Tensor:
    """The pack as one PyTorch copy: it is linear in (b, u, p, q, at, bt,
    bi, bj, c), so z is a strided view of xp, and `.contiguous()` of that
    view plus a reshape computes v1 (`layout='v1'`, fp 1) or v2. Only
    chip_smoke.py calls it, to time the library copy beside the kernel;
    the model never does."""
    b, t_out, h2, wq, c = pack_shape(xp, a_t)
    sb, st, sh, sw, sc = xp.stride()
    if layout == 'v1' and fp == 1:
        size = (b, t_out, h2, wq, a_t, 2, 2, 2, c)
        stride = (sb, 2 * st, 2 * sh, 2 * sw, 2 * st, st, sh, sw, sc)
        shape = (b, t_out, h2, wq, 8 * a_t * c)
    elif layout == 'v2' and fp >= 1 and t_out % fp == 0:
        size = (b, t_out // fp, a_t, 2, 2, 2, c, h2, fp, wq)
        stride = (sb, 2 * fp * st, 2 * st, st, sh, sw, sc, 2 * sh, 2 * st,
                  2 * sw)
        shape = (b, t_out // fp, 8 * a_t * c, h2, fp * wq)
    else:
        raise ValueError(f'bad layout {layout!r} / fp {fp} for t_out {t_out}')
    return xp.as_strided(size, stride, xp.storage_offset()).contiguous(
        ).reshape(shape)


_FORCE_PLAIN = False


@contextlib.contextmanager
def force_plain():
    """Route CUDA tensors to the plain versions (tests and chip_smoke.py
    only; the main path never uses this)."""
    global _FORCE_PLAIN
    prev, _FORCE_PLAIN = _FORCE_PLAIN, True
    try:
        yield
    finally:
        _FORCE_PLAIN = prev


def _kernel_route(xp: torch.Tensor) -> bool:
    """Whether xp goes to the kernel's custom ops: a CUDA tensor, unless
    `force_plain` is on."""
    return xp.is_cuda and not _FORCE_PLAIN


def stem_pack96(xp: torch.Tensor, a_t: int = 4) -> torch.Tensor:
    """v1 z (B, t_out, Hp/2, Wp/2, 8 a_t C): kernel on a CUDA tensor,
    plain version on a CPU tensor."""
    if _kernel_route(xp):
        return stem_pack_cuda.stem_pack96_op(xp, a_t)
    return stem_pack96_plain(xp, a_t)


def stem_pack96_v2(xp: torch.Tensor, a_t: int = 4, fp: int = 1
                   ) -> torch.Tensor:
    """v2 z (B, t_out/fp, 8 a_t C, Hp/2, fp Wp/2): kernel on a CUDA
    tensor, plain version on a CPU tensor."""
    if _kernel_route(xp):
        return stem_pack_cuda.stem_pack96_v2_op(xp, a_t, fp)
    return stem_pack96_v2_plain(xp, a_t, fp)


def pack96_weights(weight: torch.Tensor, a_t: int = 4) -> torch.Tensor:
    """The stem weight (F, C, kt, kh, kw) on the packed channel order:
    w2[f, (r, bi, bj, c), dh, dw] = w[f, c, r, 2 dh + bi, 2 dw + bj], zero
    past kt / kh / kw (`stem_pack_pallas.py:217-228`). Differentiable."""
    f, c, kt, kh, kw = weight.shape
    if kt > 2 * a_t:
        raise ValueError(f'kt {kt} exceeds 2 a_t = {2 * a_t}')
    w = F.pad(weight, (0, kw % 2, 0, kh % 2, 0, 2 * a_t - kt))
    a_h, a_w = w.shape[3] // 2, w.shape[4] // 2
    w = w.reshape(f, c, 2 * a_t, a_h, 2, a_w, 2)
    return w.permute(0, 2, 4, 6, 1, 3, 5).reshape(f, 8 * a_t * c, a_h, a_w)


def stem_conv_v2(xp: torch.Tensor, weight: torch.Tensor, a_t: int = 4,
                 fp: int = 1, chunk: int = 0) -> torch.Tensor:
    """The stride-2 VALID conv3d of xp (B, Tp, Hp, Wp, C) with weight
    (F, C, kt, kh, kw), as the v2 pack and one 2D VALID conv on NCHW:
    (B, F, t_out, Hp/2 - a_h + 1, Wp/2 - a_w + 1) in xp's dtype (weight
    is cast to it). JAX's rules (`stem_pack_pallas.py:231-274`): fp falls
    back to 1 where it does not divide t_out, the fp sub-frames' columns
    that straddle a boundary are dropped, and chunk > 0 packs the batch in
    chunks of that size so that z never exists whole."""
    if chunk and xp.shape[0] > chunk and xp.shape[0] % chunk == 0:
        return torch.cat([stem_conv_v2(xb, weight, a_t, fp)
                          for xb in xp.split(chunk)])
    b, t_out, h2, wq, _ = pack_shape(xp, a_t)
    if t_out % fp:
        fp = 1
    z = stem_pack96_v2(xp, a_t, fp)
    w2 = pack96_weights(weight, a_t).to(z.dtype)
    w_out = wq - w2.shape[3] + 1
    t2, ch = z.shape[1], z.shape[2]
    y = F.conv2d(z.reshape(b * t2, ch, h2, fp * wq), w2)
    y = torch.stack([y[..., s * wq:s * wq + w_out] for s in range(fp)], 1
                    ) if fp > 1 else y[:, None]      # (b t2, fp, F, h, w)
    y = y.reshape(b, t_out, *y.shape[2:])
    return y.permute(0, 2, 1, 3, 4).contiguous()


def stem_conv_v1(xp: torch.Tensor, weight: torch.Tensor, a_t: int = 4
                 ) -> torch.Tensor:
    """The same convolution as `stem_conv_v2`, through the channels-last
    v1 pack: the 2D conv reads z as a channels_last NCHW tensor."""
    b, t_out, h2, wq, _ = pack_shape(xp, a_t)
    z = stem_pack96(xp, a_t)
    w2 = pack96_weights(weight, a_t).to(z.dtype).contiguous(
        memory_format=torch.channels_last)
    y = F.conv2d(z.reshape(b * t_out, h2, wq, -1).permute(0, 3, 1, 2), w2)
    y = y.reshape(b, t_out, *y.shape[1:])              # (b, t, F, h, w)
    return y.permute(0, 2, 1, 3, 4).contiguous()
