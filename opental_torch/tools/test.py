"""Inference CLI: python -m opental_torch.tools.test <cfg.yaml> [flags]
[--device cuda|cpu].

Counterpart of `opental_tpu/tools/test.py` (reference
AFSD/thumos14/test.py:203-294): slides windows over every test video,
runs the (optionally RGB + flow fused) model and writes the detection
JSON, in the JAX CLI's modes (`testing.packed`, `testing.device_ingest`,
`testing.device_nms`; `testing.shared_backbone` raises). Runs on the
card unless `--device cpu` (or device='cpu') is asked for.
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


def resolve_checkpoint(path: str) -> str:
    """Follow the 'checkpoint-latest' symlink convention (test.py:15-22)."""
    if os.path.lexists(path):
        return os.path.realpath(path) if os.path.islink(path) else path
    raise FileNotFoundError(path)


def load_variables(model: torch.nn.Module, checkpoint_path: str
                   ) -> torch.nn.Module:
    """Load a reference `checkpoint-*.ckpt`, a port state_dict saved with
    torch.save, or the model weights of a port training checkpoint
    (`train/checkpoint.py`) into `model`, strictly."""
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
                   device: Optional[Union[str, torch.device]] = None
                   ) -> Tuple[InferencePipeline, dict, dict]:
    """The inference pipeline a config describes (with the 2-channel flow
    BDNet and `testing.flow_checkpoint_path` under `testing.fusion`),
    the test video infos and the class names."""
    dev = resolve_device(device)
    te = cfg.testing
    if te.get('shared_backbone', False):
        raise NotImplementedError('testing.shared_backbone is not ported '
                                  'yet')
    clip_length = cfg.get_path('dataset.testing.clip_length', 256)
    crop_size = cfg.get_path('dataset.testing.crop_size', 96)
    flags = factory.model_flags(cfg)
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
        evidence=flags['evidence'], flow_model=flow_model,
        # testing.device_nms (default true): the fused device
        # post-processing, as the JAX CLI reads it (tools/test.py:115)
        device_post=te.get('device_nms', True),
        n_candidates=te.get('n_candidates', 2048),
        device_ingest=te.get('device_ingest', True), device=dev)
    video_infos = get_video_info(
        cfg.get_path('dataset.testing.video_info_path'))
    _, idx_to_class = get_class_index_map(
        cfg.get_path('dataset.class_info_path'))
    return pipe, video_infos, idx_to_class


def run_test(cfg: Config, max_videos: Optional[int] = None,
             device: Optional[Union[str, torch.device]] = None) -> str:
    """Detection JSON of every test video; returns its path. With
    `testing.fusion` the RGB frames come from `testing.rgb_data_path` and
    the flow frames from `testing.flow_data_path`
    (`opental_tpu/tools/test.py:142-147`)."""
    te = cfg.testing
    pipe, video_infos, idx_to_class = build_pipeline(cfg, device)
    fusion = te.get('fusion', False)
    npy_path = (te.get('rgb_data_path', './datasets/thumos14/test_npy/')
                if fusion
                else cfg.get_path('dataset.testing.video_data_path'))
    flow_path = te.get('flow_data_path',
                       './datasets/thumos14/test_flow_npy/')
    names = list(video_infos.keys())[:max_videos]
    result_dict = infer_videos(pipe, te, video_infos, names, npy_path,
                               flow_path)
    for i, name in enumerate(names):
        print(f'[{i + 1}/{len(names)}] {name}: '
              f'{len(result_dict[name])} proposals')
    return proposals_to_json(result_dict, idx_to_class,
                             te.get('output_path', './output'),
                             te.get('output_json', 'detection_results.json'))


def main(argv=None) -> None:
    parser = build_arg_parser()
    parser.add_argument('--device', type=str, default='cuda',
                        help='cuda (default) or cpu')
    args = parser.parse_args(argv)
    path = run_test(config_from_namespace(args), device=args.device)
    print('wrote', path)


if __name__ == '__main__':
    main()
