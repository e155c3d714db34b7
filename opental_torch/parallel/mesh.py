"""A 1-D data mesh as a `torch.distributed` process group.

Counterpart of `opental_tpu/parallel/mesh.py`. There, one program
shards the batch (or window) axis over a `jax.sharding.Mesh` and XLA
inserts the cross-device reductions. Here each rank is a process with
its own device: `make_mesh` joins (or takes) the process group,
`shard_batch` keeps this rank's contiguous rows of the leading axis, as
`P('data')` places them, `replicate` copies rank 0's weights to every
rank and `gather_rows` all-gathers rows back in rank order, with a
backward, so that a loss can be taken over the global batch.

Nothing on a card's machine announces a cluster: the group's address,
size and rank come from torchrun's environment (`RANK`, `WORLD_SIZE`,
`LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`) or from the arguments.
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass
from typing import Any, Dict, Optional, Union

import torch
import torch.distributed as dist

@dataclass
class Mesh:
    """The data axis: the process group (None: the default group), this
    process's rank in it, its size and this rank's device."""
    group: Optional[dist.ProcessGroup]
    rank: int
    size: int
    device: torch.device
    owns_group: bool = False

    def close(self) -> None:
        """Tear the process group down if `make_mesh` started it."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
            self.owns_group = False


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def _env_int(name: str, default: Optional[int]) -> Optional[int]:
    value = os.environ.get(name)
    return default if value in (None, '') else int(value)


def make_mesh(world_size: Optional[int] = None, rank: Optional[int] = None,
              local_rank: Optional[int] = None,
              init_method: Optional[str] = None,
              backend: Optional[str] = None,
              device: Optional[Union[str, torch.device]] = None) -> Mesh:
    """Join the data mesh, or take the default process group when one is
    initialized already.

    world_size / rank / local_rank default to torchrun's `WORLD_SIZE` /
    `RANK` / `LOCAL_RANK` (else 1 / 0 / rank). init_method defaults to
    'env://' when `MASTER_ADDR` is set, else, for a world of one, a free
    localhost port; a larger world without an address raises. device:
    None or 'cuda' is `cuda:<local_rank>`, a 'cuda:<i>' names its card
    (several ranks may share one), 'cpu' the CPU; asking for the card
    where there is none raises. backend: 'nccl' on the card, 'gloo' on
    the CPU, unless named.
    """
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('no CUDA device is available for the mesh; pass '
                           'device="cpu" to run it on the CPU')
    owns = not dist.is_initialized()
    if owns:
        rank = _env_int('RANK', 0) if rank is None else rank
        world_size = (_env_int('WORLD_SIZE', 1) if world_size is None
                      else world_size)
        if init_method is None:
            if os.environ.get('MASTER_ADDR'):
                init_method = 'env://'
            elif world_size == 1:
                init_method = f'tcp://localhost:{_free_port()}'
            else:
                raise ValueError(
                    f'a mesh of {world_size} ranks needs an address: run '
                    'under torchrun, set MASTER_ADDR / MASTER_PORT or pass '
                    'init_method')
    else:
        rank, world_size = dist.get_rank(), dist.get_world_size()
    if local_rank is None:
        local_rank = _env_int('LOCAL_RANK', rank)
    if dev.type == 'cuda':
        if dev.index is None:
            dev = torch.device('cuda', local_rank)
        torch.cuda.set_device(dev)
    if owns:
        dist.init_process_group(
            backend or ('nccl' if dev.type == 'cuda' else 'gloo'),
            init_method=init_method, world_size=world_size, rank=rank)
    return Mesh(group=None, rank=rank, size=world_size, device=dev,
                owns_group=owns)


def shard_rows(mesh: Mesh, n: int) -> slice:
    """This rank's contiguous share [r n / W, (r + 1) n / W) of n rows;
    n must divide over the mesh."""
    if n % mesh.size:
        raise ValueError(f'{n} rows do not divide over a mesh of '
                         f'{mesh.size}')
    per = n // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_batch(mesh: Mesh, batch: Dict[str, Any]) -> Dict[str, Any]:
    """This rank's rows of every array in the batch (numpy or torch),
    split along the leading axis as `P('data')` places them."""
    return {k: v[shard_rows(mesh, v.shape[0])] for k, v in batch.items()}


def replicate(mesh: Mesh, module: torch.nn.Module) -> torch.nn.Module:
    """Broadcast the module's parameters and buffers from rank 0, in
    place; returns the module."""
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0, group=mesh.group)
    return module


class _GatherRows(torch.autograd.Function):
    """All-gather along dim 0 in rank order. The backward sums each
    rank's gradient of the gathered tensor and keeps this rank's rows (a
    reduce-scatter, made of an all-reduce, which gloo carries on CUDA
    tensors too)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
        ctx.mesh = mesh
        ctx.rows = x.shape[0]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(mesh.size)]
        dist.all_gather(parts, x, group=mesh.group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.mesh.group)
        lo = ctx.mesh.rank * ctx.rows
        return g[lo:lo + ctx.rows], None


def gather_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The (W * n, ...) concatenation of every rank's (n, ...) x in rank
    order (equal n on every rank). Differentiable: when every rank takes
    the same loss of the result, each rank's gradient of its own x is W
    times the loss's, and DDP's mean over the W ranks gives the loss's
    gradient of the parameters exactly. A mesh of one returns x itself
    (a copy would change its layout, and with it the summation order of
    a loss over it)."""
    if mesh.size == 1:
        return x
    if x.dtype == torch.bool:       # not every backend carries bool
        return _GatherRows.apply(x.to(torch.uint8), mesh).bool()
    return _GatherRows.apply(x, mesh)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
        ctx.mesh = mesh
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=mesh.group)
        return x

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return _AllReduceSum.apply(g, ctx.mesh), None


def all_reduce_sum(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Differentiable sum of x over the mesh's ranks: the backward sums
    the gradients the same way, as every rank's loss reads the sum."""
    return _AllReduceSum.apply(x, mesh)
