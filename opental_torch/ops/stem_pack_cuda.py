"""ctypes wrapper of the stem-pack kernel (`csrc/stem_pack.cu`): the v1
layout replaces the TPU kernel `opental_tpu/ops/stem_pack_pallas.py:44`
`_kernel` (stem_pack96), the v2 layout `:141` `_kernel_v2`
(stem_pack96_v2).

The library builds at the first call (`_build.load`), never at import.
`V1_LAUNCHES` and `V2_LAUNCHES` count the launches of each layout: each
grows by one where its kernel is launched and nowhere else. `plan`
picks the kernel's design from the layout, fp and xp's strides.

The model reaches the kernel as two `torch.library` custom ops,
`opental::stem_pack96` and `opental::stem_pack96_v2` (CUDA only, with
fake implementations for tracing, no autograd: xp takes no gradient), so
`torch.export` keeps them as graph nodes. An op receives xp with the
strides it has, so a permuted view still reaches the kernel as it is.
"""

from __future__ import annotations

import ctypes

import torch

from opental_torch.ops import _build

NAME = 'stem_pack'
V1_LAUNCHES = 0
V2_LAUNCHES = 0
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_fns = {}
PATHS = ('tile', 'frame_strided', 'frame_bulk')   # the C entry's `path`


def _entry():
    fn = _fns.get(NAME)
    if fn is None:
        fn = _build.load(NAME).stem_pack96
        fn.argtypes = [_P, _P, _I, _I, _I, _I, _I,
                       ctypes.POINTER(ctypes.c_longlong), _I, _I, _I, _I, _I,
                       _P]
        fn.restype = ctypes.c_int
        _fns[NAME] = fn
    return fn


def plan(xp: torch.Tensor, fp: int, layout: int) -> str:
    """Which design of `csrc/stem_pack.cu` packs xp: the frame plan for
    v2 at fp = 1 (one block per band of rows of one input plane), with
    one bulk copy per band where the band is contiguous (unit W stride,
    packed rows: the model's permuted view) and strided loads otherwise;
    the tile plan for v1 and for v2 at fp > 1."""
    if layout == 0 or fp != 1:
        return 'tile'
    if xp.stride(3) == 1 and xp.stride(2) == xp.shape[3]:
        return 'frame_bulk'
    return 'frame_strided'


def _launch(xp: torch.Tensor, a_t: int, fp: int, layout: int,
            path: str = '') -> torch.Tensor:
    global V1_LAUNCHES, V2_LAUNCHES
    name = 'stem_pack96_v2' if layout else 'stem_pack96'
    if not xp.is_cuda:
        raise ValueError(f'{name} needs a CUDA tensor')
    if xp.dtype not in _DTYPES:
        raise TypeError(f'xp must be float32 or bfloat16, got {xp.dtype}')
    if xp.requires_grad:
        raise ValueError(f'{name} has no backward: xp must not require a '
                         'gradient')
    if xp.dim() != 5:
        raise ValueError(f'xp must be (B, Tp, Hp, Wp, C), got '
                         f'{tuple(xp.shape)}')
    b, tp, hp, wp, c = xp.shape
    if tp % 2 or hp % 2 or wp % 2:
        raise ValueError(f'Tp, Hp, Wp must be even, got {(tp, hp, wp)}')
    t_out = tp // 2 - a_t + 1
    if a_t < 1 or t_out < 1 or fp < 1 or t_out % fp:
        raise ValueError(f'bad a_t {a_t} / fp {fp} for Tp {tp}')
    if layout == 0 and fp != 1:
        raise ValueError('the v1 layout has no fp')
    ch = 8 * a_t * c
    shape = ((b, t_out, hp // 2, wp // 2, ch) if layout == 0 else
             (b, t_out // fp, ch, hp // 2, fp * (wp // 2)))
    z = torch.empty(shape, dtype=xp.dtype, device=xp.device)
    if z.numel() == 0:
        return z
    strides = (ctypes.c_longlong * 5)(*xp.stride())
    fn = _entry()
    stream = torch.cuda.current_stream(xp.device).cuda_stream
    path = PATHS.index(path or plan(xp, fp, layout))
    with torch.cuda.device(xp.device):
        err = fn(xp.data_ptr(), z.data_ptr(), b, tp, hp, wp, c, strides,
                 a_t, fp, layout, _DTYPES[xp.dtype], path, stream)
    if layout == 0:
        V1_LAUNCHES += 1
    else:
        V2_LAUNCHES += 1
    if err != 0:
        raise RuntimeError(f'{name} launch failed: CUDA error {err}')
    return z


def stem_pack96(xp: torch.Tensor, a_t: int = 4) -> torch.Tensor:
    """v1 z (B, t_out, Hp/2, Wp/2, 8 a_t C) = kernel(xp (B, Tp, Hp, Wp, C)
    f32|bf16, any strides), on xp's device and PyTorch's current stream."""
    return _launch(xp, a_t, 1, 0)


def stem_pack96_v2(xp: torch.Tensor, a_t: int = 4, fp: int = 1
                   ) -> torch.Tensor:
    """v2 z (B, t_out/fp, 8 a_t C, Hp/2, fp Wp/2) = kernel(xp (B, Tp, Hp,
    Wp, C) f32|bf16, any strides), on xp's device and PyTorch's current
    stream."""
    return _launch(xp, a_t, fp, 1)


# ------------------------------------------------------------ custom ops

def _fake_pack(xp: torch.Tensor, a_t: int, fp: int, layout: int
               ) -> torch.Tensor:
    b, tp, hp, wp, c = xp.shape
    t_out, ch = tp // 2 - a_t + 1, 8 * a_t * c
    shape = ((b, t_out, hp // 2, wp // 2, ch) if layout == 0 else
             (b, t_out // fp, ch, hp // 2, fp * (wp // 2)))
    return xp.new_empty(shape)


@torch.library.custom_op('opental::stem_pack96', mutates_args=(),
                         device_types='cuda')
def stem_pack96_op(xp: torch.Tensor, a_t: int) -> torch.Tensor:
    """`stem_pack96` as an op."""
    return stem_pack96(xp, a_t)


@stem_pack96_op.register_fake
def _(xp, a_t):
    return _fake_pack(xp, a_t, 1, 0)


@torch.library.custom_op('opental::stem_pack96_v2', mutates_args=(),
                         device_types='cuda')
def stem_pack96_v2_op(xp: torch.Tensor, a_t: int, fp: int) -> torch.Tensor:
    """`stem_pack96_v2` as an op."""
    return stem_pack96_v2(xp, a_t, fp)


@stem_pack96_v2_op.register_fake
def _(xp, a_t, fp):
    return _fake_pack(xp, a_t, fp, 1)
