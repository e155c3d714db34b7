"""ctypes wrapper of the boundary max-pool forward kernel
(`csrc/boundary_pool.cu`), which replaces the TPU kernel
`opental_tpu/ops/boundary_pool_pallas.py:38` `_fwd_kernel`.

The library builds at the first call (`_build.load`), never at import.
`LAUNCHES` counts the kernel's launches: it grows by one where the
kernel is launched and nowhere else.
"""

from __future__ import annotations

import ctypes

import torch

from opental_torch.ops import _build

NAME = 'boundary_pool'
LAUNCHES = 0
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = _build.load(NAME).boundary_max_pool_fwd
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def boundary_max_pool_fwd(x: torch.Tensor, segments: torch.Tensor
                          ) -> torch.Tensor:
    """out (B, K, C) = kernel(x (B, T, C) f32|bf16, segments (B, K, 4)
    f32), on x's device and PyTorch's current stream."""
    global LAUNCHES
    if not (x.is_cuda and segments.is_cuda and x.device == segments.device):
        raise ValueError('boundary_max_pool_fwd needs x and segments on '
                         'the same CUDA device')
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
    if not (x.is_contiguous() and segments.is_contiguous()):
        raise ValueError('x and segments must be contiguous')
    if t_len == 0:
        raise ValueError('x has no time steps')
    out = torch.empty((b, k, c), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    fn = _entry()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), segments.data_ptr(), out.data_ptr(),
                 b, t_len, c, k, _DTYPES[x.dtype], stream)
    LAUNCHES += 1
    if err != 0:
        raise RuntimeError(f'boundary_max_pool_fwd launch failed: CUDA '
                           f'error {err}')
    return out
