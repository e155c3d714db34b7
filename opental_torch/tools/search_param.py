"""Post-processing grid search: python -m opental_torch.tools.search_param
<cfg.yaml> --gt_json ... [--sigmas 0.3 ...] [--conf_threshs 0.01 ...]
[--device cuda|cpu].

Counterpart of `opental_tpu/tools/search_param.py` (reference
AFSD/thumos14/search_param.py): the network runs ONCE per video and its
raw head outputs are cached on disk (:112-150); each candidate then
re-runs everything downstream of the network (decode, filter, soft-NMS,
the detection JSON, mAP) from the cache (:210-275). With
`testing.fusion` both streams run and the cache holds their head-wise
average, the input of decode. The cache is keyed to the weights (the
checkpoints' real paths and modification times, `manifest.json`): a
cache of other weights is emptied before use, and so is a cache with no
manifest, whose weights are unknown. The network runs on the card unless
`--device cpu` (or device='cpu') is asked for.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from opental_torch import resolve_device
from opental_torch.config import (Config, build_arg_parser,
                                  config_from_namespace)
from opental_torch.data import transforms
from opental_torch.eval.detection import DetectionEvaluator
from opental_torch.infer.decode import decode_windows, fuse_streams
from opental_torch.infer.pipeline import (ingest_windows, proposals_to_json,
                                          stack_windows_u8, window_offsets)
from opental_torch.tools.test import build_pipeline

# raw head outputs the decode stage reads (test.py:79-109)
RAW_KEYS = ('loc', 'conf', 'prop_loc', 'prop_conf', 'center', 'priors',
            'unct', 'prop_unct', 'act', 'prop_act')
MAX_BATCH = 32

Device = Optional[Union[str, torch.device]]


def _checkpoint_fingerprint(cfg: Config) -> str:
    """Identity of the weights a cache was computed with: the
    checkpoint's real path (through the checkpoint-latest link) and its
    modification time, the later of the two streams' under fusion."""
    path = os.path.realpath(cfg.get_path('testing.checkpoint_path', ''))
    mtime = os.path.getmtime(path) if os.path.exists(path) else 0.0
    flow = cfg.get_path('testing.flow_checkpoint_path', '')
    if flow:
        flow = os.path.realpath(flow)
        mtime = max(mtime, os.path.getmtime(flow)
                    if os.path.exists(flow) else 0.0)
    return f'{path}@{mtime}'


def sync_cache_manifest(cache_dir: str, fingerprint: str) -> None:
    """Empty the cache of npz entries computed with other weights, or
    with unknown ones (npz entries and no manifest: a cache written
    before manifests, which would otherwise be blessed under the current
    weights), then record `fingerprint`."""
    os.makedirs(cache_dir, exist_ok=True)
    manifest_path = os.path.join(cache_dir, 'manifest.json')
    stale = True
    if os.path.exists(manifest_path):
        with open(manifest_path) as f:
            stale = json.load(f).get('checkpoint') != fingerprint
    if stale:
        for fn in os.listdir(cache_dir):
            if fn.endswith('.npz'):
                os.remove(os.path.join(cache_dir, fn))
    with open(manifest_path, 'w') as f:
        json.dump({'checkpoint': fingerprint}, f)


_PIPE_CACHE: dict = {}


def _cached_pipeline(cfg: Config, device: Device = None):
    """build_pipeline(cfg), once per config object (held with it, so a
    recycled id() cannot alias another config's pipeline)."""
    key = id(cfg)
    if key not in _PIPE_CACHE:
        _PIPE_CACHE[key] = (cfg, build_pipeline(cfg, device))
    return _PIPE_CACHE[key][1]


def cache_raw_outputs(cfg: Config, cache_dir: str,
                      max_videos: Optional[int] = None,
                      device: Device = None) -> List[str]:
    """Run the network once per test video and cache its raw head
    outputs (search_param.py:112-150): windows staged as uint8 and
    normalized on the device, `MAX_BATCH` per forward; the RGB / flow
    npys come from `testing.rgb_data_path` / `testing.flow_data_path`
    under fusion (reference :49-52). Returns the video names."""
    sync_cache_manifest(cache_dir, _checkpoint_fingerprint(cfg))
    pipe, video_infos, _ = _cached_pipeline(cfg, device)
    fusion = pipe.flow_model is not None
    npy = (cfg.get_path('testing.rgb_data_path',
                        './datasets/thumos14/test_npy/') if fusion
           else cfg.get_path('dataset.testing.video_data_path'))
    flow_dir = cfg.get_path('testing.flow_data_path',
                            './datasets/thumos14/test_flow_npy/')
    names = list(video_infos)[:max_videos]
    for name in names:
        out_file = os.path.join(cache_dir, name + '.npz')
        if os.path.exists(out_file):
            continue
        info = video_infos[name]
        offsets = window_offsets(info['sample_count'], pipe.clip_length,
                                 pipe.stride)
        streams = [np.load(os.path.join(npy, name + '.npy'))]
        if fusion:
            streams.append(np.load(os.path.join(flow_dir, name + '.npy')))
        staged = [stack_windows_u8(transforms.center_crop(
            s, pipe.crop_size), offsets, pipe.clip_length) for s in streams]
        parts = []
        with torch.inference_mode():
            for i in range(0, len(offsets), MAX_BATCH):
                outs = [model(ingest_windows(
                    pipe._to_device(clips[i:i + MAX_BATCH]),
                    pipe._to_device(valid[i:i + MAX_BATCH])))
                    for model, (clips, valid) in zip(
                        (pipe.model, pipe.flow_model), staged)]
                out = outs[0] if len(outs) == 1 else fuse_streams(*outs)
                parts.append({k: out[k].float().cpu().numpy()
                              for k in RAW_KEYS
                              if out.get(k) is not None})
        arrays = {'offsets': np.asarray(offsets, np.float32),
                  'sample_fps': np.float32(info['sample_fps']),
                  'n': np.int32(len(offsets))}
        for k in parts[0]:
            arrays[k] = (parts[0][k] if k == 'priors'
                         else np.concatenate([p[k] for p in parts]))
        np.savez(out_file, **arrays)
    return names


def evaluate_candidate(cfg: Config, cache_dir: str, names: List[str],
                       gt_json: str, workdir: str, sigma: float,
                       conf_thresh: Optional[float] = None,
                       device: Device = None) -> float:
    """Decode, filter, soft-NMS, JSON and average mAP from the raw cache
    with candidate post-processing parameters (host NMS, as the
    reference)."""
    pipe, _, idx_to_class = _cached_pipeline(cfg, device)
    pipe.nms_sigma = sigma
    # always assign: a None candidate after another restores the
    # config's value (the cached pipeline persists across candidates)
    pipe.conf_thresh = (conf_thresh if conf_thresh is not None
                        else cfg.get_path('testing.conf_thresh', 0.01))
    results: Dict[str, list] = {}
    for name in names:
        z = np.load(os.path.join(cache_dir, name + '.npz'))
        out = {k: (torch.from_numpy(z[k]) if k in z.files else None)
               for k in RAW_KEYS}
        n = int(z['n'])
        dec = decode_windows(
            out, pipe.clip_length, use_edl=pipe.use_edl,
            os_head=pipe.os_head,
            score_func='dirichlet' if pipe.use_edl else 'softmax',
            evidence=pipe.evidence, negate_conf=pipe.use_gcpl)

        def host(a):
            return None if a is None else a[:n].numpy()

        seconds = (host(dec.segments) + z['offsets'][:, None, None]) \
            / float(z['sample_fps'])
        results[name] = pipe.post_process(seconds, host(dec.scores),
                                          host(dec.uncertainty),
                                          host(dec.actionness))
    tag = f'search_sigma_{sigma:.2f}' + (
        f'_ct_{conf_thresh:g}' if conf_thresh is not None else '')
    pred = proposals_to_json(results, idx_to_class, workdir, tag + '.json')
    ev = DetectionEvaluator(gt_json, pred,
                            cfg.get_path('dataset.class_info_path'),
                            tiou_thresholds=np.asarray([0.3, 0.4, 0.5,
                                                        0.6, 0.7]),
                            subset=['test'], openset=False)
    _, avg_map, _ = ev.evaluate('AP')
    return float(avg_map)


def main(argv=None) -> None:
    parser = build_arg_parser()
    parser.add_argument('--gt_json', type=str, required=True)
    parser.add_argument('--sigmas', nargs='+', type=float,
                        default=[0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.85,
                                 0.9, 0.95, 1.0])
    parser.add_argument('--conf_threshs', nargs='+', type=float,
                        default=[None])
    parser.add_argument('--device', type=str, default='cuda',
                        help='cuda (default) or cpu')
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    cfg = config_from_namespace(args)
    out_path = cfg.testing.get('output_path', './output')
    cache_dir = os.path.join(out_path, 'raw_cache')
    names = cache_raw_outputs(cfg, cache_dir, device=device)
    best = (None, None, -1.0)
    for ct in args.conf_threshs:
        for sigma in args.sigmas:
            score = evaluate_candidate(cfg, cache_dir, names, args.gt_json,
                                       out_path, sigma, conf_thresh=ct,
                                       device=device)
            tag = f'sigma={sigma:.2f}' + (
                f' conf_thresh={ct}' if ct is not None else '')
            print(f'{tag}: average mAP={score:.5f}')
            if score > best[2]:
                best = (sigma, ct, score)
    print(f'best: sigma={best[0]} conf_thresh={best[1]} '
          f'(average mAP={best[2]:.5f})')


if __name__ == '__main__':
    main()
