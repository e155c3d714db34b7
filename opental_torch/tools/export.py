"""Model export for serving: `python -m opental_torch.tools.export
<cfg.yaml> --out model.pt2 [--window_batch 128] [--uint8] [--device cpu]`.

Counterpart of `opental_tpu/tools/export.py`. Traces the window-batched
forward + decode, with the weights in the program, by `torch.export` at
a fixed `window_batch`, and writes it with `torch.export.save`. A
serving process loads it with `load_exported` and calls it on (W, T, H,
W, C) float32 clip batches in [-1, 1], or with `--uint8` on raw uint8
clips plus int32 frames-valid (W,), normalized inside the program by
`infer/pipeline.py::ingest_windows` (the packed and streaming
pipelines' contract, 4x less to transfer). It returns a dict of
`segments`, `scores` and, as the model has them, `uncertainty` and
`actionness`; soft-NMS composes downstream (`ops/nms.py` or the
pipeline's post-processing).

The program is not self-contained as JAX's StableHLO artifact is: on the
card it calls the hand kernels as the custom ops `opental::*`, so the
loading process imports `opental_torch.ops` (which `load_exported` does)
to register them, and needs the CUDA toolkit to build them at first use.
With `--device cpu` the program traces the kernels' plain versions, as
JAX's portable export traces its XLA twin, and needs nothing of the
package. On the card, a program that does not hold the boundary pool's
custom op is refused: the plain path is never exported in its place.
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch
from torch import nn

from opental_torch import factory, resolve_device
from opental_torch.config import Config, load_config
from opental_torch.infer.decode import decode_windows
from opental_torch.infer.pipeline import ingest_windows
from opental_torch.tools.test import inference_dtype, load_variables

POOL_OP = 'opental.boundary_max_pool_fwd'


class ServingModule(nn.Module):
    """The exported function: clips -> the decoded windows as a dict
    (`InferencePipeline.forward_decode` + `_decode`, without
    `torch.inference_mode`, which export does not trace). uint8_ingest
    takes (W, T, H, W, C) uint8 clips and int32 frames-valid (W,);
    otherwise (W, T, H, W, C) float32 clips."""

    def __init__(self, model: nn.Module, clip_length: int,
                 use_edl: bool = False, os_head: bool = False,
                 evidence: str = 'exp', negate_conf: bool = False,
                 uint8_ingest: bool = False):
        super().__init__()
        self.model = model
        self.clip_length = clip_length
        self.use_edl, self.os_head = use_edl, os_head
        self.evidence, self.negate_conf = evidence, negate_conf
        self.uint8_ingest = uint8_ingest

    def forward(self, clips: torch.Tensor,
                frames_valid: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        if self.uint8_ingest:
            x = ingest_windows(clips, frames_valid)
        else:
            x = clips.permute(0, 4, 1, 2, 3)
        dec = decode_windows(
            self.model(x), self.clip_length, use_edl=self.use_edl,
            os_head=self.os_head,
            score_func='dirichlet' if self.use_edl else 'softmax',
            evidence=self.evidence, negate_conf=self.negate_conf)
        return {k: v for k, v in dec._asdict().items() if v is not None}


def example_inputs(window_batch: int, clip_length: int, crop_size: int,
                   in_channels: int, uint8_ingest: bool,
                   device: torch.device) -> Tuple[torch.Tensor, ...]:
    shape = (window_batch, clip_length, crop_size, crop_size, in_channels)
    if uint8_ingest:
        return (torch.zeros(shape, dtype=torch.uint8, device=device),
                torch.full((window_batch,), clip_length, dtype=torch.int32,
                           device=device))
    return (torch.zeros(shape, device=device),)


def build_inference_fn(cfg: Config, window_batch: int = 128,
                       dtype: Optional[torch.dtype] = None,
                       uint8_ingest: bool = False,
                       device: Optional[Union[str, torch.device]] = None
                       ) -> Tuple[ServingModule, Tuple[torch.Tensor, ...]]:
    """The serving module of a config (its model and
    `testing.checkpoint_path`) on `device` (the card unless the CPU is
    asked for), with example inputs of its signature. dtype None is the
    inference CLIs' (bfloat16 unless `model.compute_dtype` says
    float32)."""
    dev = resolve_device(device)
    clip_length = cfg.get_path('dataset.testing.clip_length', 256)
    crop_size = cfg.get_path('dataset.testing.crop_size', 96)
    flags = factory.model_flags(cfg)
    model = factory.build_model(cfg, frame_num=clip_length,
                                crop_size=crop_size,
                                dtype=dtype or inference_dtype(cfg))
    load_variables(model, cfg.testing['checkpoint_path'])
    use_gcpl = bool(flags['use_rpl']) and bool(
        cfg.get_path('training.rpl_config.gcpl', False))
    module = serving_module(model, clip_length, flags, use_gcpl,
                            uint8_ingest, dev)
    return module, example_inputs(window_batch, clip_length, crop_size,
                                  model.in_channels, uint8_ingest, dev)


def serving_module(model: nn.Module, clip_length: int,
                   flags: Dict[str, Any], use_gcpl: bool = False,
                   uint8_ingest: bool = False,
                   device: Union[str, torch.device] = 'cpu'
                   ) -> ServingModule:
    """`model` (its weights loaded) as a frozen ServingModule on
    `device`: eval mode, and no parameter takes a gradient, so the pool
    traces its inference forward."""
    model = model.to(device).eval().requires_grad_(False)
    return ServingModule(model, clip_length, use_edl=flags['use_edl'],
                         os_head=flags['os_head'],
                         evidence=flags['evidence'], negate_conf=use_gcpl,
                         uint8_ingest=uint8_ingest).eval()


def custom_op_counts(program: torch.export.ExportedProgram
                     ) -> Dict[str, int]:
    """{op name: nodes} of the `opental::` custom ops in a program."""
    counts: Dict[str, int] = {}
    for node in program.graph.nodes:
        name = str(node.target)
        if node.op == 'call_function' and name.startswith('opental.'):
            name = name.rsplit('.', 1)[0]
            counts[name] = counts.get(name, 0) + 1
    return counts


def export_program(module: ServingModule,
                   inputs: Tuple[torch.Tensor, ...]
                   ) -> torch.export.ExportedProgram:
    """torch.export of the serving module at its inputs' shapes. On the
    card the program must hold the boundary pool's custom op, or this
    raises (never the plain path in its place)."""
    program = torch.export.export(module, inputs)
    if inputs[0].is_cuda and not custom_op_counts(program).get(POOL_OP):
        raise RuntimeError(
            f'the exported program holds no {POOL_OP} node: the kernel '
            'did not trace as its custom op; refusing to export the plain '
            'path in its place')
    # a program keeps its example inputs, and `torch.export.save` would
    # write them beside the weights (905 MB of uint8 clips at W = 128)
    program.example_inputs = None
    return program


def export_model(cfg: Config, out_path: str, window_batch: int = 128,
                 device: Optional[Union[str, torch.device]] = None,
                 uint8_ingest: bool = False) -> str:
    """Export the serving function of a config to `out_path` (.pt2)."""
    module, inputs = build_inference_fn(cfg, window_batch,
                                        uint8_ingest=uint8_ingest,
                                        device=device)
    torch.export.save(export_program(module, inputs), out_path)
    return out_path


def load_exported(path: str) -> Callable[..., Dict[str, torch.Tensor]]:
    """A saved program as a callable: clips (, frames_valid) -> dict of
    tensors. Imports `opental_torch.ops` first, so that a program
    exported on the card finds its custom ops."""
    import opental_torch.ops  # noqa: F401  (registers the opental:: ops)
    return torch.export.load(path).module()


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument('config_file')
    p.add_argument('--out', default='model.pt2')
    p.add_argument('--checkpoint_path', default=None,
                   help='override testing.checkpoint_path')
    p.add_argument('--window_batch', type=int, default=128)
    p.add_argument('--device', default='cuda',
                   help='cuda (default: the program calls the hand kernels '
                        'as custom ops) or cpu (their plain versions)')
    p.add_argument('--uint8', action='store_true',
                   help='serving signature (uint8 clips, int32 '
                        'frames-valid); normalize inside the program')
    args = p.parse_args(argv)
    resolve_device(args.device)      # no card: refuse before any file
    overrides = ({'testing.checkpoint_path': args.checkpoint_path}
                 if args.checkpoint_path else None)
    cfg = load_config(args.config_file, overrides=overrides)
    path = export_model(cfg, args.out, args.window_batch, args.device,
                        uint8_ingest=args.uint8)
    print(f'wrote {path} ({os.path.getsize(path) / 1e6:.1f} MB, '
          f'W={args.window_batch}{", uint8" if args.uint8 else ""}, '
          f'{args.device})')


if __name__ == '__main__':
    main()
