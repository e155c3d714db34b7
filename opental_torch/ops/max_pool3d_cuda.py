"""ctypes wrapper of B6, the I3D's 3D max pool kernel
(`csrc/max_pool3d.cu`): the TF-SAME zero pad computed in the kernel, no
indices written, one launch a call. It replaces no TPU kernel (the JAX
package pools with `lax.reduce_window`, which XLA fuses with its pad);
`models/layers.max_pool_3d_same_plain` (`F.pad` + `F.max_pool3d`) is
its plain version, and `models/layers.max_pool_3d_same` takes B6 for
every CUDA input whose gradient autograd will not need.

It takes the I3D's four (kernel, stride) specs (`SPECS`), float32 or
bfloat16, on an NCDHW-contiguous tensor, and raises on anything else.

The library builds at the first call (`_build.load`), never at import.
`LAUNCHES` counts the kernel's launches: it grows by one where the
kernel is launched and nowhere else, beside one `pool3d.b6` count of the
program's recorder (`utils/profiling`).

The model reaches the kernel as the `torch.library` custom op
`opental::max_pool3d_same` (CUDA only, with a fake implementation for
tracing), so `torch.export` keeps it as a graph node.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from opental_torch.ops import _build
from opental_torch.utils import profiling

NAME = 'max_pool3d'
LAUNCHES = 0
SPECS = (((1, 3, 3), (1, 2, 2)), ((3, 3, 3), (1, 1, 1)),
         ((3, 3, 3), (2, 2, 2)), ((2, 2, 2), (2, 2, 2)))
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_fns = {}


def _entry():
    fn = _fns.get(NAME)
    if fn is None:
        fn = _build.load(NAME).max_pool3d_same
        fn.argtypes = [_P, _P] + [_I] * 17 + [_P]
        fn.restype = ctypes.c_int
        _fns[NAME] = fn
    return fn


def geometry(shape: Sequence[int], kernel: Sequence[int],
             stride: Sequence[int]) -> Tuple[Tuple[int, ...],
                                             Tuple[int, ...]]:
    """(front pads, output extents) over (T, H, W) = shape[2:] of a max
    pool after the TF-SAME zero pad: the extents of `F.max_pool3d` on the
    padded tensor."""
    from opental_torch.models.layers import same_pad_amount
    pads, outs = [], []
    for size, k, s in zip(shape[2:], kernel, stride):
        front, back = same_pad_amount(size, k, s)
        pads.append(front)
        outs.append((size + front + back - k) // s + 1)
    return tuple(pads), tuple(outs)


def max_pool3d_same(x: torch.Tensor, kernel: Sequence[int],
                    stride: Sequence[int]) -> torch.Tensor:
    """y (N, C, To, Ho, Wo) = kernel(x (N, C, T, H, W) f32|bf16
    contiguous), the max over each TF-SAME zero-padded window, on x's
    device and PyTorch's current stream."""
    global LAUNCHES
    kernel = tuple(int(k) for k in kernel)
    stride = tuple(int(s) for s in stride)
    if (kernel, stride) not in SPECS:
        raise ValueError(f'kernel {kernel} / stride {stride} is not one of '
                         f'the specs B6 takes: {SPECS}')
    if not x.is_cuda:
        raise ValueError('max_pool3d_same needs a CUDA tensor (the plain '
                         'version runs on the CPU)')
    if x.dtype not in _DTYPES:
        raise TypeError(f'x must be float32 or bfloat16, got {x.dtype}')
    if x.dim() != 5 or not x.is_contiguous():
        raise ValueError(f'x must be a contiguous (N, C, T, H, W) tensor, '
                         f'got shape {tuple(x.shape)} strides {x.stride()}')
    if 0 in x.shape[2:]:
        raise ValueError(f'x has an empty extent: {tuple(x.shape)}')
    pads, outs = geometry(x.shape, kernel, stride)
    y = torch.empty(tuple(x.shape[:2]) + outs, dtype=x.dtype,
                    device=x.device)
    if y.numel() == 0:
        return y
    fn = _entry()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), y.data_ptr(), x.shape[0] * x.shape[1],
                 *x.shape[2:], *outs, *kernel, *stride, *pads,
                 _DTYPES[x.dtype], stream)
    LAUNCHES += 1
    profiling.count('pool3d.b6', 1)
    if err != 0:
        raise RuntimeError(f'max_pool3d_same launch failed: CUDA error '
                           f'{err} (shape {tuple(x.shape)})')
    return y


@torch.library.custom_op('opental::max_pool3d_same', mutates_args=(),
                         device_types='cuda')
def max_pool3d_same_op(x: torch.Tensor, kernel: List[int],
                       stride: List[int]) -> torch.Tensor:
    """`max_pool3d_same` as an op."""
    return max_pool3d_same(x, kernel, stride)


@max_pool3d_same_op.register_fake
def _(x, kernel, stride):
    return x.new_empty(tuple(x.shape[:2])
                       + geometry(x.shape, kernel, stride)[1])
