"""ActivityNet inference: the program's `tools.test_anet.AnetInference`
(what `run_test_anet` runs over the validation npys) over in-memory
videos of a seeded frame bank: every video one `clip_length` (768)
window, its frames drawn from the traffic's `frames` quantiles (a short
video is zero-padded by its frames-valid), its duration from
`duration_s`'s and its fps their ratio; `video_batch` videos a forward,
device post-processing of every (video, class) row at once.

The window: videos are offered until `--seconds` have passed; it ends
when the program returns every offered video's proposals. A window of
video is one video, so `windows_per_s` counts videos.

The check (after the window, the program's state freed) is
`infer_packed`'s on the sampled videos: `model_rel` against the plain
reference's ANet BDNet (`reference.anet_pyramid`), each row found by its
input's fingerprint; `post_gap` against the plain ANet post-processing
(`reference.anet_post`) on the program's own outputs; `missing`.

The traffic's empty `tree` is read by nothing here: the tiny copy of the
cells (`tests/tiny.py`) shrinks every traffic that is not
`infer_packed`'s as a training tree.
"""

from __future__ import annotations

import random
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from tal_bench import program, traffic, weights
from tal_bench.runners import infer_packed
from tal_bench.trace import OpCalls, Spans
from tal_bench.traffic import subseed


class AnetSource:
    """Videos as views into one seeded frame bank: video i takes its
    frame count from the `frames` quantiles and its duration from the
    `duration_s` quantiles (each set shuffled anew per pass), at a
    seeded start."""

    def __init__(self, t: Dict[str, Any], seed: int, device: torch.device,
                 bank: Optional[np.ndarray] = None):
        self.bank = bank if bank is not None else traffic.frames(
            seed, 'bank', int(t['bank_frames']), int(t['spatial']), device)
        self.lengths = traffic.lengths(t['frames'], seed)
        self.durations = traffic.lengths(t['duration_s'],
                                         subseed(seed, 'durations'))
        self.rng = random.Random(subseed(seed, 'starts'))
        self.count = 0

    def next(self):
        """(name, frames (T, H, W, 3) uint8 view, T, fps, start in the
        bank, duration in seconds)."""
        n = next(self.lengths)
        duration = float(next(self.durations))
        start = self.rng.randrange(0, len(self.bank) - n + 1)
        name = f'v_{self.count:05d}'
        self.count += 1
        return (name, self.bank[start:start + n], n, n / duration, start,
                duration)


class Runner(infer_packed.Runner):

    def __init__(self, cell, seed: int, device: torch.device,
                 trace: bool = False):
        self.cell, self.seed, self.device = cell, seed, device
        self.trace = trace
        self.t = cell.traffic
        te = cell.config['dataset']['testing']
        self.clip, self.crop = te['clip_length'], te['crop_size']
        self.stride = self.clip
        self.video_batch = int(self.t['video_batch'])
        self.rows = 0
        self.outputs: List[Dict[str, torch.Tensor]] = []
        self.prints: List[torch.Tensor] = []
        self.index = infer_packed.print_index(self.clip, self.crop)
        self.card_index = tuple(t.to(device) for t in self.index)
        self.recording = False
        self.calls: Optional[OpCalls] = None
        self.spans = Spans()

    def setup(self) -> None:
        # first: a program without the object fails here, before any work
        from opental_torch.tools.test_anet import AnetInference
        from opental_torch import factory
        from opental_torch.tools.test import inference_dtype
        cfg = program.load_config(self.cell.config)
        self.cfg = cfg
        with torch.device(self.device):
            model = factory.build_model(cfg, frame_num=self.clip,
                                        crop_size=self.crop,
                                        dtype=inference_dtype(cfg))
        model = model.to(self.device)
        weights.seed_weights(model, self.cell.config_file['weights_seed'],
                             'infer')
        self.state_dict = {k: v.detach().clone()
                           for k, v in model.state_dict().items()}
        model.register_forward_pre_hook(self._pre)
        model.register_forward_hook(self._post)
        self.infer = AnetInference(cfg, model, video_batch=self.video_batch,
                                   device=self.device)
        self.source = AnetSource(self.t, self.seed, self.device)
        warm = AnetSource(self.t, subseed(self.seed, 'warm'), self.device,
                          bank=self.source.bank)
        self.infer.run([(name, data, fps, duration)
                        for name, data, _, fps, _, duration in
                        (warm.next() for _ in range(2 * self.video_batch))])
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        self.rows = 0
        self.outputs = []

    def window(self, seconds: float) -> Dict[str, float]:
        self.offered: List[Dict[str, Any]] = []
        self.recording = True
        self.rows = 0
        if self.trace:
            self.calls = OpCalls()
        t0 = time.perf_counter()

        def videos():
            while time.perf_counter() - t0 < seconds:
                name, data, n, fps, start, duration = self.source.next()
                self.offered.append({'name': name, 'n': n, 'fps': fps,
                                     'start': start, 'duration': duration})
                yield name, data, fps, duration

        with self.spans.span('run'):
            self.results = self.infer.run(videos())
        self.wall = time.perf_counter() - t0
        self.recording = False
        self.windows = len(self.offered)
        return {'windows_per_s': self.windows / self.wall}

    def summary(self) -> Dict[str, Any]:
        out = super().summary()
        out['proposals_per_video'] = (
            sum(len(p) for p in self.results.values())
            / max(1, len(self.results)))
        return out

    def release(self) -> None:
        self.infer = None
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()

    def reference_post(self, v: int, prog: Dict[str, torch.Tensor],
                       low: bool = False) -> List[Dict[str, Any]]:
        """The plain decode and ANet post-processing of offered video v
        on the program's model outputs `prog` for its window."""
        from tal_bench.reference import anet_post, decode
        m, te = self.cfg.model, self.cfg.testing
        use_edl, os_head = bool(m.use_edl), bool(m.os_head)
        dec = decode.decode_windows(
            prog, self.clip, use_edl=use_edl, os_head=os_head,
            score_func='dirichlet' if use_edl else 'softmax',
            evidence=m.get('evidence', 'exp'))
        info = self.offered[v]
        return anet_post.proposals(
            dec, info['fps'], info['duration'],
            num_classes=self.cfg.dataset.num_classes - (1 if os_head else 0),
            os_head=os_head, use_edl=use_edl,
            n_candidates=te.get('n_candidates', 512),
            sigma=te.get('nms_sigma', 0.85), top_k=te.get('top_k', 5000),
            low=low)
