"""ctypes wrappers of the boundary max-pool kernels (`csrc/boundary_pool.cu`):
the forward replaces the TPU kernel `opental_tpu/ops/boundary_pool_pallas.py:38`
`_fwd_kernel`, the backward `:57` `_bwd_kernel`.

Both are grouped: `levels`, a table of (t_i, k_i), packs up to
`MAX_LEVELS` pooling problems along x's T axis and the segments' K axis
(`ops/boundary_pool.py` has the contract); the default, one level
(T, K), is the JAX op. The table goes to the kernel by value: no device
memory, no synchronisation.

The library builds at the first call (`_build.load`), never at import.
`LAUNCHES` counts the forward kernel's launches and `BWD_LAUNCHES` the
backward's: each grows by one where its kernel is launched and nowhere
else.

The model reaches both kernels as `torch.library` custom ops,
`opental::boundary_max_pool_fwd` and `opental::boundary_max_pool_bwd`
(CUDA only, with fake implementations for tracing; the forward's
autograd formula is the backward op), so `torch.export` keeps them as
graph nodes. The level table travels as two `int[]` arguments, by
value as before.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from opental_torch.ops import _build

NAME = 'boundary_pool'
LAUNCHES = 0
BWD_LAUNCHES = 0
MAX_LEVELS = 16
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_IP = ctypes.POINTER(ctypes.c_int)
_fns = {}

Levels = Tuple[Tuple[int, int], ...]


def check_levels(levels: Optional[Sequence[Tuple[int, int]]], t_total: int,
                 k_total: int) -> Levels:
    """The level table as a tuple of (t_i, k_i) int pairs, None meaning
    one level (t_total, k_total). Raises ValueError unless there are 1 to
    MAX_LEVELS levels, the t_i sum to t_total and the k_i to k_total, and
    every level with windows has rows."""
    if levels is None:
        levels = ((t_total, k_total),)
    levels = tuple((int(t), int(k)) for t, k in levels)
    if not 1 <= len(levels) <= MAX_LEVELS:
        raise ValueError(f'{len(levels)} levels: 1 to {MAX_LEVELS} are '
                         'taken')
    if any(t < 0 or k < 0 or (k and not t) for t, k in levels):
        raise ValueError(f'bad level sizes {levels}: a level with windows '
                         'needs rows')
    if (sum(t for t, _ in levels), sum(k for _, k in levels)) != \
            (t_total, k_total):
        raise ValueError(f'levels {levels} do not sum to T = {t_total}, '
                         f'K = {k_total}')
    return levels


def _entry(name: str, argtypes):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load(NAME), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if not all(t.is_cuda and t.device == dev for t in tensors):
        raise ValueError(f'{name} needs all its tensors on the same CUDA '
                         'device')
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f'{name} needs contiguous tensors')


def _table(levels: Levels):
    n = len(levels)
    return ((ctypes.c_int * n)(*[t for t, _ in levels]),
            (ctypes.c_int * n)(*[k for _, k in levels]), n)


def boundary_max_pool_fwd(x: torch.Tensor, segments: torch.Tensor,
                          with_argmax: bool = False,
                          levels: Optional[Sequence[Tuple[int, int]]] = None
                          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(out (B, K, C), argmax (B, K, C) int32 or None) = kernel(x (B, T, C)
    f32|bf16, segments (B, K, 4) f32, levels), on x's device and
    PyTorch's current stream. with_argmax also writes the first argmax of
    every window, an index into x's packed T axis (the training forward);
    without it the kernel moves no extra bytes."""
    global LAUNCHES
    _check_cuda('boundary_max_pool_fwd', x, segments)
    if x.dtype not in _DTYPES:
        raise TypeError(f'x must be float32 or bfloat16, got {x.dtype}')
    if segments.dtype != torch.float32:
        raise TypeError(f'segments must be float32, got {segments.dtype}')
    if x.dim() != 3 or segments.dim() != 3 or segments.shape[-1] != 4 \
            or segments.shape[0] != x.shape[0]:
        raise ValueError(f'bad shapes x {tuple(x.shape)} segments '
                         f'{tuple(segments.shape)}')
    b, t_len, c = x.shape
    k = segments.shape[1]
    if c % 2:
        raise ValueError('channel count must split into start/end halves')
    if t_len == 0:
        raise ValueError('x has no time steps')
    ts, ks, n = _table(check_levels(levels, t_len, k))
    out = torch.empty((b, k, c), dtype=x.dtype, device=x.device)
    argmax = (torch.empty((b, k, c), dtype=torch.int32, device=x.device)
              if with_argmax else None)
    if out.numel() == 0:
        return out, argmax
    fn = _entry('boundary_max_pool_fwd', [_P, _P, _P, _P, _I, _I, _I, _I,
                                          _IP, _IP, _I, _I, _P])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), segments.data_ptr(), out.data_ptr(),
                 None if argmax is None else argmax.data_ptr(),
                 b, t_len, c, k, ts, ks, n, _DTYPES[x.dtype], stream)
    LAUNCHES += 1
    if err != 0:
        raise RuntimeError(f'boundary_max_pool_fwd launch failed: CUDA '
                           f'error {err}')
    return out, argmax


def boundary_max_pool_bwd(argmax: torch.Tensor, g: torch.Tensor,
                          t_len: int,
                          levels: Optional[Sequence[Tuple[int, int]]] = None
                          ) -> torch.Tensor:
    """dx (B, T, C) in g's dtype = kernel(argmax (B, K, C) int32 from the
    training forward on the same levels, g (B, K, C) f32|bf16): g[b, k, c]
    added at row argmax[b, k, c], in ascending k, without atomics."""
    global BWD_LAUNCHES
    _check_cuda('boundary_max_pool_bwd', argmax, g)
    if g.dtype not in _DTYPES:
        raise TypeError(f'g must be float32 or bfloat16, got {g.dtype}')
    if argmax.dtype != torch.int32:
        raise TypeError(f'argmax must be int32, got {argmax.dtype}')
    if g.dim() != 3 or argmax.shape != g.shape:
        raise ValueError(f'bad shapes argmax {tuple(argmax.shape)} g '
                         f'{tuple(g.shape)}')
    if t_len <= 0:
        raise ValueError(f't_len {t_len} is not positive')
    b, k, c = g.shape
    ts, ks, n = _table(check_levels(levels, t_len, k))
    dx = torch.empty((b, t_len, c), dtype=g.dtype, device=g.device)
    if dx.numel() == 0:
        return dx
    fn = _entry('boundary_max_pool_bwd', [_P, _P, _P, _I, _I, _I, _I, _IP,
                                          _IP, _I, _I, _P])
    stream = torch.cuda.current_stream(g.device).cuda_stream
    with torch.cuda.device(g.device):
        err = fn(argmax.data_ptr(), g.data_ptr(), dx.data_ptr(), b, t_len,
                 c, k, ts, ks, n, _DTYPES[g.dtype], stream)
    BWD_LAUNCHES += 1
    if err != 0:
        raise RuntimeError(f'boundary_max_pool_bwd launch failed: CUDA '
                           f'error {err}')
    return dx


# ------------------------------------------------------------ custom ops

def _levels_of(level_t: List[int], level_k: List[int]) -> Levels:
    return tuple(zip(level_t, level_k))


@torch.library.custom_op('opental::boundary_max_pool_fwd', mutates_args=(),
                         device_types='cuda')
def boundary_max_pool_fwd_op(x: torch.Tensor, segments: torch.Tensor,
                             level_t: List[int], level_k: List[int],
                             with_argmax: bool
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`boundary_max_pool_fwd` as an op: (out, argmax), argmax an empty
    int32 tensor unless with_argmax (an op returns no None)."""
    out, argmax = boundary_max_pool_fwd(x, segments, with_argmax,
                                        _levels_of(level_t, level_k))
    if argmax is None:
        argmax = torch.empty(0, dtype=torch.int32, device=x.device)
    return out, argmax


@boundary_max_pool_fwd_op.register_fake
def _(x, segments, level_t, level_k, with_argmax):
    shape = (x.shape[0], segments.shape[1], x.shape[2])
    return (x.new_empty(shape),
            x.new_empty(shape if with_argmax else (0,), dtype=torch.int32))


@torch.library.custom_op('opental::boundary_max_pool_bwd', mutates_args=(),
                         device_types='cuda')
def boundary_max_pool_bwd_op(argmax: torch.Tensor, g: torch.Tensor,
                             t_len: int, level_t: List[int],
                             level_k: List[int]) -> torch.Tensor:
    """`boundary_max_pool_bwd` as an op."""
    return boundary_max_pool_bwd(argmax, g, t_len,
                                 _levels_of(level_t, level_k))


@boundary_max_pool_bwd_op.register_fake
def _(argmax, g, t_len, level_t, level_k):
    return g.new_empty((g.shape[0], t_len, g.shape[2]))


def _setup_context(ctx, inputs, output):
    x, _, level_t, level_k, with_argmax = inputs
    ctx.with_argmax = with_argmax
    ctx.t_len, ctx.level_t, ctx.level_k = x.shape[1], level_t, level_k
    ctx.save_for_backward(output[1])


def _backward(ctx, g_out, _g_argmax):
    if not ctx.with_argmax:
        raise RuntimeError('boundary_max_pool_fwd ran without its argmax: '
                           'call it with with_argmax=True to differentiate')
    (argmax,) = ctx.saved_tensors
    dx = boundary_max_pool_bwd_op(argmax, g_out.contiguous(), ctx.t_len,
                                  ctx.level_t, ctx.level_k)
    return dx, None, None, None, None


torch.library.register_autograd('opental::boundary_max_pool_fwd', _backward,
                                setup_context=_setup_context)
