"""ctypes wrappers of the boundary max-pool kernels (`csrc/boundary_pool.cu`):
the forward replaces the TPU kernel `opental_tpu/ops/boundary_pool_pallas.py:38`
`_fwd_kernel`, the backward `:57` `_bwd_kernel`.

The library builds at the first call (`_build.load`), never at import.
`LAUNCHES` counts the forward kernel's launches and `BWD_LAUNCHES` the
backward's: each grows by one where its kernel is launched and nowhere
else.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from opental_torch.ops import _build

NAME = 'boundary_pool'
LAUNCHES = 0
BWD_LAUNCHES = 0
# the backward keeps a (T, 32) float32 accumulator per block in shared
# memory: at most 227 KB a block on Hopper
MAX_BWD_T = 1800
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_fns = {}


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


def boundary_max_pool_fwd(x: torch.Tensor, segments: torch.Tensor,
                          with_argmax: bool = False
                          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(out (B, K, C), argmax (B, K, C) int32 or None) = kernel(x (B, T, C)
    f32|bf16, segments (B, K, 4) f32), on x's device and PyTorch's current
    stream. with_argmax also writes the first argmax of every window (the
    training forward); without it the kernel moves no extra bytes."""
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
    out = torch.empty((b, k, c), dtype=x.dtype, device=x.device)
    argmax = (torch.empty((b, k, c), dtype=torch.int32, device=x.device)
              if with_argmax else None)
    if out.numel() == 0:
        return out, argmax
    fn = _entry('boundary_max_pool_fwd', [_P, _P, _P, _P, _I, _I, _I, _I,
                                          _I, _P])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), segments.data_ptr(), out.data_ptr(),
                 None if argmax is None else argmax.data_ptr(),
                 b, t_len, c, k, _DTYPES[x.dtype], stream)
    LAUNCHES += 1
    if err != 0:
        raise RuntimeError(f'boundary_max_pool_fwd launch failed: CUDA '
                           f'error {err}')
    return out, argmax


def boundary_max_pool_bwd(argmax: torch.Tensor, g: torch.Tensor,
                          t_len: int) -> torch.Tensor:
    """dx (B, T, C) in g's dtype = kernel(argmax (B, K, C) int32 from the
    training forward, g (B, K, C) f32|bf16): g[b, k, c] added at row
    argmax[b, k, c], in ascending k, without atomics."""
    global BWD_LAUNCHES
    _check_cuda('boundary_max_pool_bwd', argmax, g)
    if g.dtype not in _DTYPES:
        raise TypeError(f'g must be float32 or bfloat16, got {g.dtype}')
    if argmax.dtype != torch.int32:
        raise TypeError(f'argmax must be int32, got {argmax.dtype}')
    if g.dim() != 3 or argmax.shape != g.shape:
        raise ValueError(f'bad shapes argmax {tuple(argmax.shape)} g '
                         f'{tuple(g.shape)}')
    if not 0 < t_len <= MAX_BWD_T:
        raise ValueError(f't_len {t_len} outside (0, {MAX_BWD_T}]')
    b, k, c = g.shape
    dx = torch.empty((b, t_len, c), dtype=g.dtype, device=g.device)
    if dx.numel() == 0:
        return dx
    fn = _entry('boundary_max_pool_bwd', [_P, _P, _P, _I, _I, _I, _I, _I,
                                          _P])
    stream = torch.cuda.current_stream(g.device).cuda_stream
    with torch.cuda.device(g.device):
        err = fn(argmax.data_ptr(), g.data_ptr(), dx.data_ptr(), b, t_len,
                 c, k, _DTYPES[g.dtype], stream)
    BWD_LAUNCHES += 1
    if err != 0:
        raise RuntimeError(f'boundary_max_pool_bwd launch failed: CUDA '
                           f'error {err}')
    return dx
