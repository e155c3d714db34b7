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
card scores the current one. Post-processing (`infer/post.py`) filters
and soft-NMSes every (video, class) of a batch at once on the card
(`device_blocks`; 189 priors fit the candidate preselect, so it keeps
what the host loop keeps), or with `testing.device_nms: false` in the
host numpy loop (`host_rows`).
Output keys drop the 'v_' prefix and segments are clamped to the video's
duration (anet/test.py:183-239). `--binary` is the binary-actionness
variant: one class per video from a video-level classifier file, its
score fused into the proposals'. Runs on the card unless `--device cpu`.
`AnetInference` is the inference itself, built once and run over
in-memory videos; `run_test_anet` feeds it the npys and writes the JSON.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from opental_torch import factory, resolve_device
from opental_torch.config import Config, build_arg_parser, \
    config_from_namespace
from opental_torch.data import transforms
from opental_torch.data.anet import get_video_info
from opental_torch.data.prefetch import prefetch_items
from opental_torch.infer import post
from opental_torch.infer.decode import decode_windows
from opental_torch.infer.pipeline import (_require_u8, fused_forward,
                                          ingest_windows)
from opental_torch.tools.test import inference_dtype, load_variables
from opental_torch.utils import profiling


def load_class_names(class_info_path: str) -> Dict[int, str]:
    with open(class_info_path) as f:
        lines = [ln.strip() for ln in f.read().splitlines() if ln.strip()]
    return {i + 1: name for i, name in enumerate(lines)}


def stage_window(data: np.ndarray, clip_length: int, crop_size: int
                 ) -> np.ndarray:
    """(clip_length, crop, crop, C) float32 in [-1, 1] of a video's
    (T, H, W, C) frames: center crop, the tail padded with 127.5 or the
    video cut (anet/test.py:80-92)."""
    data = transforms.center_crop(data.astype(np.float32), crop_size)
    t = data.shape[0]
    if t < clip_length:
        data = np.concatenate([data, np.full(
            (clip_length - t,) + data.shape[1:], 127.5, np.float32)], 0)
    else:
        data = data[:clip_length]
    return (data / 255.0) * 2.0 - 1.0


def stage_window_u8(data: np.ndarray, clip_length: int, crop_size: int,
                    what: str = 'frames'):
    """stage_window's uint8 twin: (raw uint8 window zero-padded or cut,
    frames valid); `ingest_windows` normalizes it on the card and zeroes
    the frames past the valid count, the 127.5 pad's exact value."""
    _require_u8(data, what)
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


class AnetInference:
    """ActivityNet inference over in-memory videos, built once from the
    model (and the flow model under fusion) and the configuration's
    testing settings: every video is one `clip_length` window, and
    `video_batch` videos go through one fused forward
    (`infer.pipeline.fused_forward`), the ragged tail padded with the
    last video (and its fps), whose rows are never read back. Videos are
    staged on a prefetch thread: uint8 frames (the run's first video
    decides for the whole run) as raw bytes with their frames-valid,
    normalized on the card (`ingest_windows`); other frames as float32
    on the host (`stage_window`). Post-processing runs on the card
    (`infer.post.device_blocks`) or, with `testing.device_nms: false`, in
    the host numpy loop (`infer.post.host_rows`); segments are clamped to
    the video's duration (anet/test.py:183-239). `binary` is the
    binary-actionness mode's post-processing (score floors of 1e-9, no
    actionness gate; test_binary.py:125, 155).

    Spans: `ingest.stage` (prefetch thread; rid the batch),
    `ingest.wait`, `infer.forward` (rid the batch; counters
    `infer.rows`, the padded rows, and `infer.windows`, the videos) and
    `post.batch` (rid the batch) > `post.preselect`, `post.soft_nms`,
    `post.fetch`, `post.format` (with the host loop: `post.fetch`,
    `post.format` > `post.soft_nms`).
    """

    def __init__(self, cfg: Config, model: torch.nn.Module,
                 flow_model: Optional[torch.nn.Module] = None,
                 video_batch: int = 4, binary: bool = False,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        te = cfg.testing
        self.clip_length = cfg.get_path('dataset.testing.clip_length', 768)
        self.crop_size = cfg.get_path('dataset.testing.crop_size', 96)
        flags = factory.model_flags(cfg)
        self.use_edl, self.os_head = flags['use_edl'], flags['os_head']
        self.evidence = flags['evidence']
        self.cls_cols = post.class_columns(
            flags['num_classes'] - (1 if self.os_head else 0), self.os_head)
        self.models = tuple(m.to(self.device).eval()
                            for m in (model, flow_model) if m is not None)
        self.video_batch, self.binary = video_batch, binary
        self.sigma = te.get('nms_sigma', 0.85)
        self.top_k = te.get('top_k', 5000)
        self.device_post = te.get('device_nms', True)
        self.n_candidates = te.get('n_candidates', 512)
        # test_binary.py:125, 155 against test.py:134, 166
        self.floor = 1e-9 if binary else 0.001

    def run(self, videos) -> Dict[str, List[Dict[str, Any]]]:
        """{name: proposals} of every video (see `batches`)."""
        return {name: props for batch in self.batches(videos)
                for name, props in batch}

    def batches(self, videos) -> Iterator[List[Tuple[str, List[dict]]]]:
        """[(name, proposals)] of each batch in turn. videos: iterable of
        (name, frames (T, H, W, C), fps, duration in seconds), with the
        flow frames fifth under fusion, consumed lazily on the prefetch
        thread. A proposal: 'cls' (the class index, 1-based for os_head),
        'score', 'segment' [start, end] in seconds, 'uncertainty',
        'actionness'."""
        fusion = len(self.models) == 2
        u8 = None

        def chunks():
            chunk = []
            for item in videos:
                chunk.append(item)
                if len(chunk) == self.video_batch:
                    yield chunk
                    chunk = []
            if chunk:
                yield chunk

        def stage(indexed):
            nonlocal u8
            b, chunk = indexed
            with profiling.span('ingest.stage', b):
                streams = [[item[1] for item in chunk]]
                if fusion:
                    streams.append([item[4] for item in chunk])
                if u8 is None:
                    u8 = all(s[0].dtype == np.uint8 for s in streams)
                staged = [self._stage(s, [item[0] for item in chunk],
                                      u8, 'flow frames' if j else 'frames')
                          for j, s in enumerate(streams)]
                fps = [item[2] for item in chunk]
                fps += [fps[-1]] * (self.video_batch - len(fps))
                return b, chunk, staged, np.asarray(fps, np.float32)

        with contextlib.closing(prefetch_items(
                enumerate(chunks()), transform=stage,
                wait='ingest.wait')) as staged_batches:
            for b, chunk, staged, fps in staged_batches:
                with torch.inference_mode():
                    with profiling.span('infer.forward', b):
                        profiling.count('infer.rows', self.video_batch)
                        profiling.count('infer.windows', len(chunk))
                        dec = decode_windows(
                            fused_forward(self.models, [
                                self._clips(s) for s in staged]),
                            self.clip_length, use_edl=self.use_edl,
                            os_head=self.os_head,
                            score_func='dirichlet' if self.use_edl
                            else 'softmax', evidence=self.evidence)
                    with profiling.span('post.batch', b):
                        done = self._post(dec, chunk, fps)
                yield done

    def _stage(self, frames: List[np.ndarray], names: List[str], u8: bool,
               what: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """One stream of a batch: (windows, frames valid) padded to
        video_batch rows; frames valid None for float32 windows."""
        if not u8:
            return pad_video_batch(np.stack([
                stage_window(f, self.clip_length, self.crop_size)
                for f in frames]), self.video_batch), None
        outs = [stage_window_u8(f, self.clip_length, self.crop_size,
                                f'{what} ({name})')
                for f, name in zip(frames, names)]
        return (pad_video_batch(np.stack([o[0] for o in outs]),
                                self.video_batch),
                pad_video_batch(np.asarray([o[1] for o in outs], np.int32),
                                self.video_batch))

    def _clips(self, staged) -> torch.Tensor:
        x, valid = staged
        x = torch.from_numpy(x).to(self.device, non_blocking=True)
        if valid is not None:
            return ingest_windows(x, torch.from_numpy(valid).to(self.device))
        return x.permute(0, 4, 1, 2, 3).contiguous()

    def _post(self, dec, chunk, fps: np.ndarray
              ) -> List[Tuple[str, List[dict]]]:
        """Each video of the batch with its proposals."""
        unct = dec.uncertainty if self.use_edl else None
        act = dec.actionness if self.os_head else None
        gate = self.os_head and not self.binary           # test.py:135
        if self.device_post:
            rate = torch.from_numpy(fps).to(self.device)
            blocks = post.device_blocks(
                dec.segments.float() / rate[:, None, None],
                dec.scores.float(), unct, act, self.cls_cols, self.floor,
                gate, self.n_candidates, self.sigma, self.top_k,
                nms_floor=self.floor)
            with profiling.span('post.fetch'):
                blocks = blocks.cpu().numpy()          # (B, C, k, D + 1)
            rows = [post.device_rows(b, self.cls_cols) for b in blocks]
        else:
            with profiling.span('post.fetch'):
                segs, scores, unct, act = [
                    None if a is None else a.float().cpu().numpy()
                    for a in (dec.segments, dec.scores, unct, act)]
            rows = [post.host_rows(
                segs[vi] / fps_v, scores[vi],
                None if unct is None else unct[vi],
                None if act is None else act[vi], self.cls_cols, self.floor,
                gate, self.sigma, self.top_k, nms_floor=self.floor)
                for vi, (_, _, fps_v, *_) in enumerate(chunk)]
        with profiling.span('post.format'):
            return [(name, post.proposals(r, self.use_edl, self.os_head,
                                          duration))
                    for (name, _, _, duration, *_), r in zip(chunk, rows)]


def run_test_anet(cfg: Config, max_videos: Optional[int] = None,
                  video_batch: int = 4, binary: bool = False,
                  cls_score_file: Optional[str] = None,
                  subset: str = 'validation', video_names=None,
                  device: Optional[Union[str, torch.device]] = None) -> str:
    """Detection JSON (ActivityNet-v1.3 schema) of the `subset` videos of
    `dataset.testing.video_info_path` whose npy exists (restricted to
    `video_names` where given); returns its path. The videos' npys load
    on `AnetInference`'s prefetch thread. The compute dtype is bfloat16
    unless `model.compute_dtype` says float32."""
    dev = resolve_device(device)
    te = cfg.testing
    clip_length = cfg.get_path('dataset.testing.clip_length', 768)
    crop_size = cfg.get_path('dataset.testing.crop_size', 96)
    fusion = te.get('fusion', False)

    def build(checkpoint, in_channels=None):
        model = factory.build_model(cfg, frame_num=clip_length,
                                    crop_size=crop_size,
                                    dtype=inference_dtype(cfg),
                                    in_channels=in_channels)
        return load_variables(model, checkpoint)

    # RGB + flow late fusion by head-wise averaging (anet/test_fusion.py)
    infer = AnetInference(
        cfg, build(te['checkpoint_path']),
        build(te['flow_checkpoint_path'], 2) if fusion else None,
        video_batch=video_batch, binary=binary, device=dev)

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

    # binary-actionness mode: a video-level classifier file supplies the
    # labels, {'results': {name: [scores]}, 'class': [names]}
    # (test_binary.py:195-211, result_tsn_val.json schema)
    cls_scores: Dict[str, List[float]] = {}
    cls_actions: List[str] = []
    if binary and cls_score_file:
        with open(cls_score_file) as f:
            cls_data = json.load(f)
        cls_scores, cls_actions = cls_data['results'], cls_data['class']

    def videos():
        for name in names:
            info = video_infos[name]
            item = (name, np.load(os.path.join(npy_dir, name + '.npy')),
                    info['fps'], info['duration'])
            if fusion:
                item += (np.load(os.path.join(flow_dir, name + '.npy')),)
            yield item

    result_dict: Dict[str, List[dict]] = {}
    done = 0
    for batch in infer.batches(videos()):
        for name, found in batch:
            props = [{'label': idx_to_class.get(p['cls'], str(p['cls'])),
                      'score': p['score'], 'segment': p['segment'],
                      'uncertainty': p['uncertainty'],
                      'actionness': p['actionness']} for p in found]
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
        done += len(batch)
        print(f'[{done}/{len(names)}] videos')

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
