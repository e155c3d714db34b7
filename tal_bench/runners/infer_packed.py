"""Dataset-scale packed inference: `InferencePipeline.run_videos` with
device ingest, as `infer.pipeline.infer_videos` calls it (packed
forwards of `packed_batch` windows over flushes of `packed_frames`
frames, device post-processing), on videos fed lazily from a seeded
frame bank in host memory.

The window: videos are offered until `--seconds` have passed; the
window ends when `run_videos` returns, and every window of every video
offered counts.

The check (after the window, the program's state freed): a sample of
the finished videos drawn from the seed, the longest among them.
* `model_rel`: the program's model outputs for every window of the
  sampled videos (kept by a forward hook, by reference) against the
  plain reference model in float32 (TF32 off) on the same windows, cut
  from the same frames: the largest relative l2 gap over the output
  heads. Each output row is found by its content, not by the
  scheduler's packing: the forward pre-hook keeps a few pixels of every
  row it forwards, and each window of a sampled video takes the row
  whose pixels match the same pixels cut by the benchmark from its
  frames (the frames' ramp makes every window's pixels distinct). A
  window no row matches makes the numbers infinite.
* `post_gap`: the program's proposals of each sampled video against the
  plain decode, preselect and soft-NMS run on the program's own model
  outputs for that video (`reference.post.gap`): the post-processing
  stage checked on its own, since soft-NMS is discontinuous in its
  inputs' rounding.
"""

from __future__ import annotations

import random
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from tal_bench import program, traffic, weights
from tal_bench.compare import exact_f32, rel_gap
from tal_bench.trace import OpCalls, Spans
from tal_bench.traffic import subseed

OUTPUT_KEYS = ('loc', 'conf', 'prop_loc', 'prop_conf', 'center', 'act',
               'prop_act', 'unct', 'prop_unct')
DECODE_KEYS = OUTPUT_KEYS + ('priors',)
REF_BLOCK = 8           # windows per reference forward
PRINT_STRIDE = 8        # frames between a fingerprint's readings
# a row matches a window where no value read differs by more than this
# (bfloat16 rounds a value in [-1, 1] by at most 2 ** -8; one uint8 step
# is 2 / 255)
MATCH_TOL = 3.0 / 255.0


def window_offsets(sample_count: int, clip: int, stride: int) -> List[int]:
    """Sliding-window offsets with the tail window (AFSD
    thumos14/test.py:48-56)."""
    if sample_count < clip:
        return [0]
    offs = list(range(0, sample_count - clip + 1, stride))
    if (sample_count - clip) % stride:
        offs.append(sample_count - clip)
    return offs


def print_index(clip: int, crop: int):
    """Where a window's fingerprint reads: every PRINT_STRIDE-th frame at
    a few fixed pixels of the crop."""
    frames = torch.arange(0, clip, PRINT_STRIDE)
    ys = torch.tensor([crop // 5, crop // 2, crop * 5 // 6])
    xs = torch.tensor([crop * 3 // 7, crop // 2, crop // 4])
    return frames, ys, xs


def fingerprint(x: torch.Tensor, frames, ys, xs) -> torch.Tensor:
    """(W, C, clip, crop, crop) model input -> (W, D) float32: the
    values at `print_index`'s frames and pixels."""
    x = x[:, :, frames]
    x = x[:, :, :, ys, xs]
    return x.float().reshape(x.shape[0], -1)


class Runner:
    kind = 'infer'

    def __init__(self, cell, seed: int, device: torch.device,
                 trace: bool = False):
        self.cell, self.seed, self.device = cell, seed, device
        self.trace = trace
        self.t = cell.traffic
        cfg = cell.config
        self.clip = cfg['dataset']['testing']['clip_length']
        self.stride = cfg['dataset']['testing']['clip_stride']
        self.crop = cfg['dataset']['testing']['crop_size']
        self.max_batch = int(self.t['packed_batch'])
        self.capacity = int(self.t['packed_frames'])
        self.rows = 0
        self.outputs: List[Dict[str, torch.Tensor]] = []
        self.prints: List[torch.Tensor] = []
        self.index = print_index(self.clip, self.crop)
        # on the card for the pre-hook: a copy from the host there would
        # wait for the device
        self.card_index = tuple(t.to(device) for t in self.index)
        self.recording = False
        self.calls: Optional[OpCalls] = None
        self.spans = Spans()

    # ----------------------------------------------------------- set-up

    def setup(self) -> None:
        from opental_torch import factory
        from opental_torch.infer.pipeline import InferencePipeline
        from opental_torch.tools.test import inference_dtype
        cfg = program.load_config(self.cell.config)
        self.cfg = cfg
        te = cfg.testing
        flags = factory.model_flags(cfg)
        with torch.device(self.device):
            model = factory.build_model(cfg, frame_num=self.clip,
                                        crop_size=self.crop,
                                        dtype=inference_dtype(cfg))
        model = model.to(self.device)
        # one model for every seed, as a deployment holds its checkpoint:
        # with weights from the run's seed the soft-NMS work changed by a
        # third from seed to seed
        weights.seed_weights(model, self.cell.config_file['weights_seed'],
                             'infer')
        self.state_dict = {k: v.detach().clone()
                           for k, v in model.state_dict().items()}
        self.pipe = InferencePipeline(
            model, clip_length=self.clip, stride=self.stride,
            crop_size=self.crop, conf_thresh=te.get('conf_thresh', 0.01),
            top_k=te.get('top_k', 5000), nms_sigma=te.get('nms_sigma', 0.5),
            use_edl=flags['use_edl'], os_head=flags['os_head'],
            use_gcpl=False, evidence=flags['evidence'],
            device_post=te.get('device_nms', True),
            n_candidates=te.get('n_candidates', 2048),
            device_ingest=te.get('device_ingest', True),
            shared_backbone=te.get('shared_backbone', False),
            device=self.device)
        model.register_forward_pre_hook(self._pre)
        model.register_forward_hook(self._post)
        self.source = traffic.VideoSource(self.t, self.seed, self.device)
        # warm-up: one flush of this mix's videos (the W = max_batch
        # forward, device ingest and post-processing at their shapes)
        warm = traffic.VideoSource(self.t, subseed(self.seed, 'warm'),
                                   self.device, bank=self.source.bank)
        videos, frames = [], 0
        while frames < self.capacity // 2:
            name, data, n, fps, _ = warm.next()
            videos.append((name, data, n, fps))
            frames += n
        self.pipe.run_videos(iter(videos), max_batch=self.max_batch,
                             frames_capacity=self.capacity)
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        self.rows = 0
        self.outputs = []

    def _pre(self, module, args):
        self.rows += int(args[0].shape[0])
        self.spans.enter('forward')
        if self.recording:
            self.prints.append(fingerprint(args[0], *self.card_index))
        if self.calls is not None:
            self.calls.__enter__()

    def _post(self, module, args, out):
        if self.calls is not None:
            self.calls.__exit__(None, None, None)
        self.spans.exit()
        if self.recording:
            self.outputs.append({k: out[k] for k in DECODE_KEYS
                                 if out.get(k) is not None})

    # ----------------------------------------------------------- window

    def window(self, seconds: float) -> Dict[str, float]:
        self.offered: List[Dict[str, Any]] = []
        self.recording = True
        self.rows = 0
        if self.trace:
            self.calls = OpCalls()
        t0 = time.perf_counter()

        def videos():
            while time.perf_counter() - t0 < seconds:
                name, data, n, fps, start = self.source.next()
                self.offered.append({'name': name, 'n': n, 'fps': fps,
                                     'start': start})
                yield name, data, n, fps

        with self.spans.span('run_videos'):
            self.results = self.pipe.run_videos(
                videos(), max_batch=self.max_batch,
                frames_capacity=self.capacity)
        wall = time.perf_counter() - t0
        self.recording = False
        self.windows = sum(len(window_offsets(v['n'], self.clip,
                                              self.stride))
                           for v in self.offered)
        self.wall = wall
        return {'windows_per_s': self.windows / wall}

    def summary(self) -> Dict[str, Any]:
        return {'wall_s': self.wall, 'videos': len(self.offered),
                'windows': self.windows, 'rows': self.rows,
                'frames': sum(v['n'] for v in self.offered)}

    def attempts(self):
        """(videos offered, videos without proposals)."""
        return (len(self.offered),
                sum(v['name'] not in self.results for v in self.offered))

    def counters(self) -> Dict[str, Any]:
        from tal_bench import counting
        return {'windows': self.windows, 'rows': self.rows,
                'flops_per_unit': counting.model_flops(
                    self.cell.config, self.clip, self.crop, 1, train=False),
                'calls': self.calls}

    # ------------------------------------------------------------ check

    def release(self) -> None:
        """Free the program's state; keep what the check reads."""
        self.pipe = None
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()

    def sample(self) -> List[int]:
        """Indices of the sampled videos: the longest offered, then
        others drawn from the seed, up to the mix's count."""
        n = len(self.offered)
        longest = max(range(n), key=lambda i: self.offered[i]['n'])
        rest = [i for i in range(n) if i != longest]
        rng = random.Random(subseed(self.seed, 'check'))
        rng.shuffle(rest)
        return [longest] + rest[:int(self.t['check']['videos']) - 1]

    def video_outputs(self, videos: List[int]
                      ) -> Dict[int, Optional[Dict[str, torch.Tensor]]]:
        """The program's model outputs of each of `videos`' windows, each
        window's row found by its fingerprint among every row forwarded
        in the window (None for a video where some window matches no
        row)."""
        prints = torch.cat(self.prints)
        where = [(f, r) for f, p in enumerate(self.prints)
                 for r in range(p.shape[0])]
        out: Dict[int, Optional[Dict[str, torch.Tensor]]] = {}
        for v in videos:
            want = self.window_prints(v).to(prints.device)
            best, rows = [], []
            for i in range(0, want.shape[0], REF_BLOCK):
                d = (want[i:i + REF_BLOCK, None] - prints[None]).abs() \
                    .amax(-1)
                b, r = d.min(dim=1)
                best.append(b)
                rows.append(r)
            best, rows = torch.cat(best), torch.cat(rows).tolist()
            if bool((best > MATCH_TOL).any()):
                out[v] = None
                continue
            fr = [where[r] for r in rows]
            out[v] = {k: (torch.stack([self.outputs[f][k][r]
                                       for f, r in fr])
                          if k != 'priors' else self.outputs[0][k])
                      for k in self.outputs[0]}
        return out

    def window_prints(self, v: int) -> torch.Tensor:
        """(W, D) fingerprints of offered video v's windows, read by the
        benchmark from its frames: centre crop, (x / 255) * 2 - 1, zero
        past the video's end."""
        info = self.offered[v]
        frames, ys, xs = self.index
        lo = (self.source.bank.shape[1] - self.crop) // 2
        offs = torch.tensor(window_offsets(info['n'], self.clip,
                                           self.stride))
        t = offs[:, None] + frames[None]                  # (W, F)
        valid = t < info['n']
        t = torch.where(valid, t, 0) + info['start']
        data = torch.from_numpy(self.source.bank[
            t.reshape(-1, 1).numpy(), lo + ys.numpy()[None],
            lo + xs.numpy()[None]])
        x = (data.float() / 255.0) * 2.0 - 1.0            # (W*F, P, C)
        x = x.reshape(t.shape[0], t.shape[1], -1, x.shape[-1])
        x = torch.where(valid[:, :, None, None], x, 0.0)
        return x.permute(0, 3, 1, 2).reshape(t.shape[0], -1)

    def windows_of(self, v: int) -> torch.Tensor:
        """(W, 3, clip, crop, crop) float32 windows of offered video v,
        cut by the benchmark from its frames: centre crop, (x / 255) * 2
        - 1, zero past the video's end."""
        info = self.offered[v]
        data = self.source.bank[info['start']:info['start'] + info['n']]
        h = data.shape[1]
        lo = (h - self.crop) // 2
        data = torch.from_numpy(np.ascontiguousarray(
            data[:, lo:lo + self.crop, lo:lo + self.crop]))
        offs = window_offsets(info['n'], self.clip, self.stride)
        out = torch.zeros((len(offs), self.clip, self.crop, self.crop, 3))
        for i, o in enumerate(offs):
            part = data[o:o + self.clip].float()
            out[i, :part.shape[0]] = (part / 255.0) * 2.0 - 1.0
        return out.permute(0, 4, 1, 2, 3)

    def reference_outputs(self, v: int, dtype=None
                          ) -> Dict[str, torch.Tensor]:
        from tal_bench.reference import build
        if getattr(self, '_ref', None) is None or self._ref_dtype != dtype:
            self._ref = build.load(
                build.model(self.cell.config, self.clip, self.crop, dtype),
                self.state_dict, self.device).eval()
            self._ref_dtype = dtype
        x = self.windows_of(v)
        outs: List[Dict[str, torch.Tensor]] = []
        with torch.no_grad(), exact_f32():
            for i in range(0, x.shape[0], REF_BLOCK):
                o = self._ref(x[i:i + REF_BLOCK].to(self.device))
                outs.append({k: o[k].float() for k in OUTPUT_KEYS
                             if o.get(k) is not None})
        return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}

    def post_flags(self) -> Dict[str, Any]:
        te, m = self.cfg.testing, self.cfg.model
        return dict(num_classes=self.cfg.dataset.num_classes - (
            1 if m.os_head else 0), os_head=bool(m.os_head),
            use_edl=bool(m.use_edl), conf_thresh=te.get('conf_thresh', 0.01),
            n_candidates=te.get('n_candidates', 2048),
            sigma=te.get('nms_sigma', 0.5), top_k=te.get('top_k', 5000))

    def reference_post(self, v: int, prog: Dict[str, torch.Tensor],
                       low: bool = False) -> List[Dict[str, Any]]:
        """The plain decode, preselect and soft-NMS of offered video v
        on the program's model outputs `prog` for its windows."""
        from tal_bench.reference import decode, post
        flags = self.post_flags()
        dec = decode.decode_windows(
            prog, self.clip, use_edl=flags['use_edl'],
            os_head=flags['os_head'],
            score_func='dirichlet' if flags['use_edl'] else 'softmax',
            evidence=self.cfg.model.get('evidence', 'exp'))
        info = self.offered[v]
        return post.proposals(
            dec, window_offsets(info['n'], self.clip, self.stride),
            info['fps'], low=low, **flags)

    def check(self) -> List[Dict[str, Any]]:
        from tal_bench.reference import post
        limits = self.t['check']['limits']
        sample = self.sample()
        outs = self.video_outputs(sample)
        missing = sum(v['name'] not in self.results for v in self.offered)
        model_rel, post_gap = 0.0, 0.0
        for v in sample:
            prog = outs[v]
            if prog is None:
                model_rel = post_gap = float('inf')
                break
            model_rel = max(model_rel, rel_gap(prog,
                                               self.reference_outputs(v)))
            post_gap = max(post_gap, post.gap(
                self.results[self.offered[v]['name']],
                self.reference_post(v, prog)))
        values = {'missing': missing, 'model_rel': model_rel,
                  'post_gap': post_gap}
        return [{'name': k, 'value': values[k], 'limit': v}
                for k, v in limits.items()]
