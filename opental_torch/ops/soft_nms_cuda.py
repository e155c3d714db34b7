"""ctypes wrapper of the soft-NMS kernel (`csrc/soft_nms.cu`): every
row's whole greedy pick loop in one launch, one block a row, with the
row on chip. It replaces no TPU kernel (the JAX package's soft-NMS is a
`lax.while_loop` that XLA compiles whole); `ops/nms.soft_nms_plain` is
its plain version, and `ops/nms.soft_nms_device` takes it for every CUDA
call. A row of up to `REGISTER_N` candidates is held in registers; a
longer one in the output, which the same loop reads back each pick.

The library builds at the first call (`_build.load`), never at import.
`LAUNCHES` counts the kernel's launches: it grows by one where the
kernel is launched and nowhere else.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from opental_torch.ops import _build

NAME = 'soft_nms'
LAUNCHES = 0
REGISTER_N = 8192   # candidates a row in registers: 1024 threads x 8
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_INT_MAX = 2 ** 31 - 1
_fns = {}


def _entry():
    fn = _fns.get(NAME)
    if fn is None:
        fn = _build.load(NAME).soft_nms
        fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _P]
        fn.restype = ctypes.c_int
        _fns[NAME] = fn
    return fn


def _reciprocal(sigma: float) -> float:
    """1 / sigma in double, as PyTorch takes it to divide a tensor by a
    Python scalar on the card (ctypes then rounds it to float)."""
    return 1.0 / sigma if sigma else math.copysign(math.inf, sigma)


def soft_nms(segments: torch.Tensor, valid: Optional[torch.Tensor],
             sigma: float, top_k: int, score_threshold: float
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out (..., N, D+1) f32, picks (...) int64) = kernel(segments (...,
    N, D) f32 contiguous [start, end, score, ...], valid (..., N) bool or
    None), on segments' device and PyTorch's current stream, without a
    synchronisation: `ops/nms.soft_nms_device`'s contract."""
    global LAUNCHES
    if segments.dtype != torch.float32:
        raise TypeError(f'segments must be float32, got {segments.dtype}')
    if not segments.is_cuda:
        raise ValueError('soft_nms needs a CUDA tensor (soft_nms_plain '
                         'runs on the CPU)')
    if segments.dim() < 2 or segments.shape[-1] < 3:
        raise ValueError(f'bad segments shape {tuple(segments.shape)}: '
                         '(..., N, D >= 3) is taken')
    if not segments.is_contiguous():
        raise ValueError('soft_nms needs contiguous segments')
    n, d = segments.shape[-2:]
    if n > _INT_MAX:
        raise ValueError(f'{n} candidates a row: at most {_INT_MAX} fit')
    batch = segments.shape[:-2]
    if valid is not None:
        if valid.device != segments.device or valid.dtype != torch.bool:
            raise ValueError('valid must be a bool tensor on segments\' '
                             'device')
        if valid.shape != segments.shape[:-1] or not valid.is_contiguous():
            raise ValueError(f'valid must be contiguous of shape '
                             f'{tuple(segments.shape[:-1])}, got '
                             f'{tuple(valid.shape)}')
    out = torch.empty(batch + (n, d + 1), dtype=torch.float32,
                      device=segments.device)
    picks = torch.empty(batch, dtype=torch.int64, device=segments.device)
    rows = picks.numel()
    if rows == 0:
        return out, picks
    fn = _entry()
    stream = torch.cuda.current_stream(segments.device).cuda_stream
    with torch.cuda.device(segments.device):
        err = fn(segments.data_ptr(),
                 None if valid is None else valid.data_ptr(),
                 out.data_ptr(), picks.data_ptr(), rows, n, d,
                 max(min(top_k, _INT_MAX), -1), _reciprocal(sigma),
                 score_threshold, stream)
    LAUNCHES += 1
    if err != 0:
        raise RuntimeError(f'soft_nms launch failed: CUDA error {err}')
    return out, picks

