"""ActivityNet inference CLI: python -m opental_torch.tools.test_anet
<cfg.yaml> [flags] [--device cuda|cpu] [--video_batch N] [--max_videos N]
[--binary --cls_score_file FILE].

Counterpart of `opental_tpu/tools/test_anet.py` (reference
AFSD/anet/test.py and test_binary.py). Every video is one window of
`clip_length` frames, so videos batch along the window axis:
`video_batch` videos per forward, the ragged tail padded with the last
video (and its fps), whose rows are never read back. Raw uint8 npys are
staged with each video's frames-valid and normalized on the card
(`infer.pipeline.ingest_windows`: the reference's 127.5 pad normalizes
to exactly 0.0); float npys take the host-normalized path. The next
batch loads on a host thread (`data.prefetch.prefetch_items`) while the
card scores the current one. Post-processing filters and soft-NMSes
every (video, class) of a batch at once on the card (`build_device_post`;
189 priors fit the candidate preselect, so it keeps what the host loop
keeps), or with `testing.device_nms: false` in the host numpy loop.
Output keys drop the 'v_' prefix and segments are clamped to the video's
duration (anet/test.py:183-239). `--binary` is the binary-actionness
variant: one class per video from a video-level classifier file, its
score fused into the proposals'. Runs on the card unless `--device cpu`.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from opental_torch import factory, resolve_device
from opental_torch.config import Config, build_arg_parser, \
    config_from_namespace
from opental_torch.data import transforms
from opental_torch.data.anet import get_video_info
from opental_torch.data.prefetch import prefetch_items
from opental_torch.infer.decode import decode_windows, fuse_streams
from opental_torch.infer.pipeline import _require_u8, ingest_windows
from opental_torch.ops.nms import soft_nms_device, soft_nms_numpy
from opental_torch.tools.test import inference_dtype, load_variables


def build_device_post(cls_cols: Sequence[int], use_edl: bool,
                      os_head: bool, binary: bool, sigma: float,
                      top_k: int, n_candidates: int = 512) -> Callable:
    """post(segments (B, P, 2) frames, scores (B, P, K), unct (B, P) or
    None, act (B, P) or None, fps (B,)) -> (B, C, k, D + 1) blocks on the
    card: per video and class the score filter, a top-k preselect and
    soft-NMS, all (video, class) rows in one batched `soft_nms_device`
    (`opental_tpu/tools/test_anet.py:38-86`). The last column flags the
    kept rows."""
    conf_floor = 1e-9 if binary else 0.001   # test_binary.py:125
    # binary mode also lowers the soft-NMS score floor to 1e-9
    # (test_binary.py:155 vs test.py:166's 0.001)
    nms_floor = 1e-9 if binary else 1e-3
    cols_idx = list(cls_cols)

    def post(segments, scores, unct, act, fps):
        seconds = segments.float() / fps[:, None, None]      # (B, P, 2)
        b, p = seconds.shape[:2]
        k_eff = min(n_candidates, p)
        sc = scores[..., cols_idx].transpose(1, 2).float()   # (B, C, P)
        keep = sc > conf_floor
        if os_head and not binary:
            keep = keep & (act > 0.5)[:, None, :]            # test.py:135
        sc = torch.where(keep, sc, 0.0)
        # a stable sort puts equal scores in index order, as lax.top_k
        top_sc, idx = torch.sort(sc, dim=-1, descending=True, stable=True)
        top_sc, idx = top_sc[..., :k_eff], idx[..., :k_eff]  # (B, C, k)

        def take(v):                                         # v (B, P, d)
            return torch.gather(
                v[:, None].expand(-1, len(cols_idx), -1, -1), 2,
                idx[..., None].expand(-1, -1, -1, v.shape[-1]))

        cols = [take(seconds), top_sc[..., None]]
        if use_edl:
            cols.append(take(unct.float()[..., None]))
        if os_head:
            cols.append(take(act.float()[..., None]))
        kept, _ = soft_nms_device(torch.cat(cols, -1), sigma=sigma,
                                  top_k=top_k, score_threshold=nms_floor,
                                  valid=top_sc > 0)
        return kept

    return post


def load_class_names(class_info_path: str) -> Dict[int, str]:
    with open(class_info_path) as f:
        lines = [ln.strip() for ln in f.read().splitlines() if ln.strip()]
    return {i + 1: name for i, name in enumerate(lines)}


def prepare_window(npy_path: str, clip_length: int, crop_size: int
                   ) -> np.ndarray:
    """(clip_length, crop, crop, C) float32 in [-1, 1]: center crop, the
    tail padded with 127.5 or the video cut (anet/test.py:80-92)."""
    data = transforms.center_crop(np.load(npy_path).astype(np.float32),
                                  crop_size)
    t = data.shape[0]
    if t < clip_length:
        data = np.concatenate([data, np.full(
            (clip_length - t,) + data.shape[1:], 127.5, np.float32)], 0)
    else:
        data = data[:clip_length]
    return (data / 255.0) * 2.0 - 1.0


def prepare_window_u8(npy_path: str, clip_length: int, crop_size: int):
    """prepare_window's uint8 twin: (raw uint8 window zero-padded or cut,
    frames valid); `ingest_windows` normalizes it on the card and zeroes
    the frames past the valid count, the 127.5 pad's exact value."""
    data = np.load(npy_path)
    _require_u8(data, f'frames ({os.path.basename(npy_path)})')
    data = transforms.center_crop(data, crop_size)
    valid = min(data.shape[0], clip_length)
    out = np.zeros((clip_length,) + data.shape[1:], np.uint8)
    out[:valid] = data[:valid]
    return out, np.int32(valid)


def pad_video_batch(arr: Optional[np.ndarray], video_batch: int
                    ) -> Optional[np.ndarray]:
    """A ragged tail batch padded to video_batch rows by repeating its last
    row (every forward has the same shape; padded rows are not read)."""
    if arr is None or arr.shape[0] == video_batch:
        return arr
    reps = np.repeat(arr[-1:], video_batch - arr.shape[0], 0)
    return np.concatenate([arr, reps], 0)


def _npy_is_u8(directory: str, name: str) -> bool:
    return np.load(os.path.join(directory, name + '.npy'),
                   mmap_mode='r').dtype == np.uint8


def _rows(post_block: Optional[np.ndarray], segs, scores, unct, act,
          vi: int, cl: int, fps: float, binary: bool, os_head: bool,
          use_edl: bool, sigma: float, top_k: int) -> np.ndarray:
    """The kept [start s, end s, score, (unct), (act)] rows of one video
    and class: from the device block, or by the host loop."""
    if post_block is not None:
        return post_block[(post_block[:, -1] > 0)
                          & (post_block[:, 2] > 0)][:, :-1]
    if binary:
        # binary filtering keeps everything above 1e-9, no actionness
        # gate (test_binary.py:125)
        mask = scores[vi, :, cl] > 1e-9
    else:
        mask = scores[vi, :, cl] > 0.001                    # test.py:134
        if os_head:
            mask &= act[vi] > 0.5
    if not mask.any():
        return np.zeros((0, 3))
    cols = [segs[vi][mask] / fps, scores[vi, mask, cl][:, None]]
    if use_edl:
        cols.append(unct[vi, mask][:, None])
    if os_head:
        cols.append(act[vi, mask][:, None])
    kept, _ = soft_nms_numpy(np.concatenate(cols, 1), sigma=sigma,
                             top_k=top_k,
                             score_threshold=1e-9 if binary else 1e-3)
    return kept


def run_test_anet(cfg: Config, max_videos: Optional[int] = None,
                  video_batch: int = 4, binary: bool = False,
                  cls_score_file: Optional[str] = None,
                  subset: str = 'validation', video_names=None,
                  device: Optional[Union[str, torch.device]] = None) -> str:
    """Detection JSON (ActivityNet-v1.3 schema) of the `subset` videos of
    `dataset.testing.video_info_path` whose npy exists (restricted to
    `video_names` where given); returns its path. The compute dtype is
    bfloat16 unless `model.compute_dtype` says float32."""
    dev = resolve_device(device)
    te = cfg.testing
    clip_length = cfg.get_path('dataset.testing.clip_length', 768)
    crop_size = cfg.get_path('dataset.testing.crop_size', 96)
    flags = factory.model_flags(cfg)
    use_edl, os_head = flags['use_edl'], flags['os_head']
    num_classes = flags['num_classes'] - (1 if os_head else 0)
    fusion = te.get('fusion', False)

    def build(checkpoint, in_channels=None):
        model = factory.build_model(cfg, frame_num=clip_length,
                                    crop_size=crop_size,
                                    dtype=inference_dtype(cfg),
                                    in_channels=in_channels)
        return load_variables(model, checkpoint).to(dev).eval()

    model = build(te['checkpoint_path'])
    # RGB + flow late fusion by head-wise averaging (anet/test_fusion.py)
    flow_model = build(te['flow_checkpoint_path'], 2) if fusion else None
    score_func = 'dirichlet' if use_edl else 'softmax'

    def forward_decode(clips, flow_clips=None):
        out = model(clips)
        if flow_model is not None:
            out = fuse_streams(out, flow_model(flow_clips))
        return decode_windows(out, clip_length, use_edl=use_edl,
                              os_head=os_head, score_func=score_func,
                              evidence=flags['evidence'])

    video_infos = get_video_info(
        cfg.get_path('dataset.testing.video_info_path'), subset)
    idx_to_class = load_class_names(cfg.get_path('dataset.class_info_path'))
    npy_dir = cfg.get_path('dataset.testing.video_mp4_path')
    flow_dir = te.get('flow_data_path', npy_dir)
    names = [n for n in video_infos
             if os.path.exists(os.path.join(npy_dir, n + '.npy'))]
    if video_names is not None:
        # calibration intersects with the classifier file's videos
        # (anet/threshold.py:35-38)
        allowed = set(video_names)
        names = [n for n in names if n in allowed]
    names = names[:max_videos]
    # one staging mode for the run, from the first video: raw uint8 npys
    # (the reference's and ours) ship as bytes, float npys as float32
    staging_u8 = bool(names) and _npy_is_u8(npy_dir, names[0]) and (
        not fusion or _npy_is_u8(flow_dir, names[0]))

    # binary-actionness mode: a video-level classifier file supplies the
    # labels, {'results': {name: [scores]}, 'class': [names]}
    # (test_binary.py:195-211, result_tsn_val.json schema)
    cls_scores: Dict[str, List[float]] = {}
    cls_actions: List[str] = []
    if binary and cls_score_file:
        with open(cls_score_file) as f:
            cls_data = json.load(f)
        cls_scores, cls_actions = cls_data['results'], cls_data['class']

    def stage(directory, chunk):
        paths = [os.path.join(directory, n + '.npy') for n in chunk]
        if staging_u8:
            outs = [prepare_window_u8(p, clip_length, crop_size)
                    for p in paths]
            return (pad_video_batch(np.stack([o[0] for o in outs]),
                                    video_batch),
                    pad_video_batch(np.asarray([o[1] for o in outs],
                                               np.int32), video_batch))
        return pad_video_batch(np.stack([
            prepare_window(p, clip_length, crop_size) for p in paths]),
            video_batch), None

    def assemble(i):
        # on the prefetch thread: load + crop batch i + 1 while the card
        # scores batch i
        chunk = names[i:i + video_batch]
        fps = [video_infos[n]['fps'] for n in chunk]
        # padded rows take the last fps, as they take the last video
        fps += [fps[-1]] * (video_batch - len(fps))
        return (i, chunk, stage(npy_dir, chunk),
                stage(flow_dir, chunk) if fusion else None,
                np.asarray(fps, np.float32))

    def to_clips(staged):
        x, valid = staged
        x = torch.from_numpy(x).to(dev, non_blocking=True)
        if valid is not None:
            return ingest_windows(x, torch.from_numpy(valid).to(dev))
        return x.permute(0, 4, 1, 2, 3).contiguous()

    cls_rng = list(range(0, num_classes) if os_head
                   else range(1, num_classes))
    sigma = te.get('nms_sigma', 0.85)
    top_k = te.get('top_k', 5000)
    post_fn = (build_device_post(cls_rng, use_edl, os_head, binary, sigma,
                                 top_k, te.get('n_candidates', 512))
               if te.get('device_nms', True) else None)
    result_dict: Dict[str, List[dict]] = {}
    with contextlib.closing(prefetch_items(
            range(0, len(names), video_batch), assemble)) as batches, \
            torch.inference_mode():
        for i, chunk, rgb, flow, fps in batches:
            dec = forward_decode(to_clips(rgb),
                                 to_clips(flow) if fusion else None)
            blocks = segs = scores = unct = act = None
            if post_fn is not None:
                blocks = post_fn(dec.segments, dec.scores, dec.uncertainty,
                                 dec.actionness,
                                 torch.from_numpy(fps).to(dev)
                                 ).cpu().numpy()       # (B, C, k, D + 1)
            else:
                segs = dec.segments.float().cpu().numpy()
                scores = dec.scores.float().cpu().numpy()
                unct = (dec.uncertainty.float().cpu().numpy()
                        if use_edl else None)
                act = (dec.actionness.float().cpu().numpy()
                       if os_head else None)
            for vi, name in enumerate(chunk):
                duration = video_infos[name]['duration']
                props = []
                for ci, cl in enumerate(cls_rng):
                    kept = _rows(None if blocks is None else blocks[vi, ci],
                                 segs, scores, unct, act, vi, cl,
                                 video_infos[name]['fps'], binary, os_head,
                                 use_edl, sigma, top_k)
                    cl_idx = cl + 1 if os_head else cl
                    for row in kept:
                        if row[2] <= 0:
                            continue
                        start_t = max(0.0, float(row[0]))
                        end_t = min(duration, float(row[1]))
                        if end_t <= start_t:
                            continue
                        props.append({
                            'label': idx_to_class.get(cl_idx, str(cl_idx)),
                            'score': float(row[2]),
                            'segment': [start_t, end_t],
                            'uncertainty': (float(row[3]) if use_edl
                                            else 0.0),
                            'actionness': (float(row[-1]) if os_head
                                           else 0.0),
                        })
                key = name[2:] if name.startswith('v_') else name
                if binary and key in cls_scores:
                    # one class per video, the classifier's argmax, its
                    # confidence fused into the proposals' scores
                    # (test_binary.py:163-176, 210-211)
                    v_scores = cls_scores[key]
                    pred_class = cls_actions[int(np.argmax(v_scores))]
                    pred_conf = float(np.max(v_scores))
                    props = [dict(p, label=pred_class,
                                  score=p['score'] * pred_conf)
                             for p in props]
                result_dict[key] = props
            print(f'[{min(i + video_batch, len(names))}/{len(names)}] '
                  'videos')

    payload = {'version': 'ActivityNet-v1.3', 'results': result_dict,
               'external_data': {}}
    out_dir = te.get('output_path', './output')
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, te.get('output_json',
                                            'detection_results.json'))
    with open(out_path, 'w') as f:
        json.dump(payload, f)
    return out_path


def main(argv=None) -> None:
    parser = build_arg_parser()
    parser.add_argument('--device', type=str, default='cuda',
                        help='cuda (default) or cpu')
    parser.add_argument('--binary', action='store_true',
                        help='binary-actionness mode (anet/test_binary.py)')
    parser.add_argument('--cls_score_file', type=str, default=None,
                        help='video-level classifier JSON '
                             '(result_tsn_val.json schema)')
    parser.add_argument('--video_batch', type=int, default=4,
                        help='videos per forward')
    parser.add_argument('--max_videos', type=int, default=None)
    args = parser.parse_args(argv)
    print('wrote', run_test_anet(
        config_from_namespace(args), max_videos=args.max_videos,
        video_batch=args.video_batch, binary=args.binary,
        cls_score_file=args.cls_score_file, device=args.device))


if __name__ == '__main__':
    main()
