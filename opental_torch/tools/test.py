"""Inference CLI: python -m opental_torch.tools.test <cfg.yaml> [flags]
[--device cuda|cpu].

Counterpart of `opental_tpu/tools/test.py` (reference
AFSD/thumos14/test.py:203-294): slides windows over every test video,
runs the (optionally RGB + flow fused) model and writes the detection
JSON, in the JAX CLI's modes (`testing.packed`, `testing.device_ingest`,
`testing.device_nms`, `testing.shared_backbone`). A GCPL config
(`training.rpl_config.gcpl` with `model.use_rpl`) decodes negated
distances. Runs on the card unless `--device cpu` (or device='cpu') is
asked for.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple, Union

import torch

from opental_torch import factory, resolve_device
from opental_torch.config import Config, build_arg_parser, \
    config_from_namespace
from opental_torch.data.thumos import get_class_index_map, get_video_info
from opental_torch.infer.pipeline import (InferencePipeline, infer_videos,
                                          packed_frames, proposals_to_json)
from opental_torch.parallel.mesh import Mesh


def resolve_checkpoint(path: str) -> str:
    """Follow the 'checkpoint-latest' symlink convention (test.py:15-22)."""
    if os.path.lexists(path):
        return os.path.realpath(path) if os.path.islink(path) else path
    raise FileNotFoundError(path)


def load_variables(model: torch.nn.Module, checkpoint_path: str
                   ) -> torch.nn.Module:
    """Load a reference `checkpoint-*.ckpt`, a port state_dict saved with
    torch.save, or the model weights of a port training checkpoint
    (`train/checkpoint.py`) into `model`, strictly. The RPL radius, which
    a reference checkpoint lacks (the reference keeps it in its loss
    module) and inference does not read, keeps the model's value when
    the file has none."""
    path = resolve_checkpoint(checkpoint_path)
    if os.path.isdir(path):
        raise ValueError(
            f'{path} is a directory (an orbax checkpoint of the JAX '
            'package?): reading it needs JAX. Restore its variables where '
            'JAX is installed and convert them with '
            'opental_torch.utils.convert.from_jax_variables, then '
            'torch.save the state_dict')
    sd = torch.load(path, map_location='cpu', weights_only=True)
    if isinstance(sd.get('model'), dict):
        sd = sd['model']
    sd = {k: v for k, v in sd.items()
          if not k.endswith('num_batches_tracked')}
    radius = 'coarse_pyramid_detection.rpl_radius'
    own = model.state_dict()
    if radius in own and radius not in sd:
        sd[radius] = own[radius]
    model.load_state_dict(sd, strict=True)
    return model


def inference_dtype(cfg: Config) -> torch.dtype:
    """The inference CLIs' compute dtype: bfloat16 unless
    `model.compute_dtype` says float32 (the JAX CLIs' default,
    `opental_tpu/tools/test.py:83-85`)."""
    if cfg.get_path('model.compute_dtype') in ('float32', 'f32'):
        return torch.float32
    return torch.bfloat16


def build_pipeline(cfg: Config,
                   device: Optional[Union[str, torch.device]] = None,
                   mesh: Optional[Mesh] = None
                   ) -> Tuple[InferencePipeline, dict, dict]:
    """The inference pipeline a config describes (with the 2-channel flow
    BDNet and `testing.flow_checkpoint_path` under `testing.fusion`),
    the test video infos and the class names. With a mesh the pipeline
    splits each forward's windows over its ranks, on the mesh's device."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    te = cfg.testing
    clip_length = cfg.get_path('dataset.testing.clip_length', 256)
    crop_size = cfg.get_path('dataset.testing.crop_size', 96)
    flags = factory.model_flags(cfg)
    use_gcpl = bool(flags['use_rpl']) and bool(
        cfg.get_path('training.rpl_config.gcpl', False))
    dtype = inference_dtype(cfg)
    model = factory.build_model(cfg, frame_num=clip_length,
                                crop_size=crop_size, dtype=dtype)
    load_variables(model, te['checkpoint_path'])
    flow_model = None
    if te.get('fusion', False):
        flow_model = factory.build_model(cfg, frame_num=clip_length,
                                         crop_size=crop_size, dtype=dtype,
                                         in_channels=2)
        load_variables(flow_model, te['flow_checkpoint_path'])
    pipe = InferencePipeline(
        model, clip_length=clip_length,
        stride=cfg.get_path('dataset.testing.clip_stride', 128),
        crop_size=crop_size, conf_thresh=te.get('conf_thresh', 0.01),
        top_k=te.get('top_k', 5000), nms_sigma=te.get('nms_sigma', 0.5),
        use_edl=flags['use_edl'], os_head=flags['os_head'],
        use_gcpl=use_gcpl, evidence=flags['evidence'],
        flow_model=flow_model,
        # testing.device_nms (default true): the fused device
        # post-processing, as the JAX CLI reads it (tools/test.py:115)
        device_post=te.get('device_nms', True),
        n_candidates=te.get('n_candidates', 2048),
        device_ingest=te.get('device_ingest', True),
        # testing.shared_backbone (default off): one backbone pass per
        # span of 4 windows, as the JAX CLI reads it (tools/test.py:130)
        shared_backbone=te.get('shared_backbone', False), device=dev,
        mesh=mesh)
    video_infos = get_video_info(
        cfg.get_path('dataset.testing.video_info_path'))
    _, idx_to_class = get_class_index_map(
        cfg.get_path('dataset.class_info_path'))
    return pipe, video_infos, idx_to_class


def run_test(cfg: Config, max_videos: Optional[int] = None,
             device: Optional[Union[str, torch.device]] = None,
             mesh: Optional[Mesh] = None) -> str:
    """Detection JSON of every test video; returns its path. With
    `testing.fusion` the RGB frames come from `testing.rgb_data_path` and
    the flow frames from `testing.flow_data_path`
    (`opental_tpu/tools/test.py:142-147`). With a mesh
    (`parallel.mesh.make_mesh`) every rank runs the same videos, each
    forward split over the ranks, and rank 0 alone writes the JSON."""
    te = cfg.testing
    pipe, video_infos, idx_to_class = build_pipeline(cfg, device, mesh)
    fusion = te.get('fusion', False)
    npy_path = (te.get('rgb_data_path', './datasets/thumos14/test_npy/')
                if fusion
                else cfg.get_path('dataset.testing.video_data_path'))
    flow_path = te.get('flow_data_path',
                       './datasets/thumos14/test_flow_npy/')
    names = list(video_infos.keys())[:max_videos]
    result_dict = infer_videos(pipe, te, video_infos, names, npy_path,
                               flow_path)
    output_path = te.get('output_path', './output')
    json_name = te.get('output_json', 'detection_results.json')
    if mesh is not None and mesh.rank != 0:
        return os.path.join(output_path, json_name)
    for i, name in enumerate(names):
        print(f'[{i + 1}/{len(names)}] {name}: '
              f'{len(result_dict[name])} proposals')
    return proposals_to_json(result_dict, idx_to_class, output_path,
                             json_name)


def main(argv=None) -> None:
    parser = build_arg_parser()
    parser.add_argument('--device', type=str, default='cuda',
                        help='cuda (default) or cpu')
    args = parser.parse_args(argv)
    path = run_test(config_from_namespace(args), device=args.device)
    print('wrote', path)


if __name__ == '__main__':
    main()
