"""Two-stream packed inference: `infer_packed`'s cell with the RGB model
and the flow model (the same BDNet with 2 input channels) on every
window, every output head averaged before decoding, as
`tools.test.build_pipeline` runs the configuration's `testing.fusion`.

Each video is a view of the seeded RGB bank and of a seeded 2-channel
flow bank of the same frames, the flow one frame shorter (TVL1 gives a
frame fewer); the program takes the flow frames as each video's fifth
item (`run_videos`). The flow weights come from the configuration's own
`flow_weights_seed`. The window, its rate and the samples of the check
are `infer_packed`'s.

The check (after the window, the program's state freed), on the
sampled videos' windows, each row found by the fingerprints of both
streams' inputs (`rows_of`; the RGB stream's own outputs by the RGB
input's alone):
* `model_rel`: the program's fused outputs (the dict its pipeline hands
  to decoding) against the reference's two BDNets (in_channels 3 and 2,
  loaded from the program's two state dicts) fused by
  `reference.decode.fuse_streams`, both on windows the benchmark cuts
  from the two banks;
* `rgb_rel`, `flow_rel`: each stream's own outputs (its model's forward
  hook) against its reference alone, so that a fault can be placed. A
  window whose flow input is not the flow window the benchmark cuts
  matches no row, and its video's fused and flow numbers are infinite:
  on noise frames the outputs barely depend on which noise a window
  holds, so a flow stream fed the wrong frames would pass an output
  comparison alone;
* `post_gap`: `infer_packed`'s, on the program's fused outputs.

The traffic's empty `tree` is read by nothing here: the tiny copy of the
cells (`tests/tiny.py`) shrinks every traffic that is not
`infer_packed`'s as a training tree.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from tal_bench import program, traffic, weights
from tal_bench.compare import exact_f32, rel_gap
from tal_bench.runners import infer_packed
from tal_bench.runners.infer_packed import (DECODE_KEYS, MATCH_TOL,
                                            OUTPUT_KEYS, PRINT_STRIDE,
                                            REF_BLOCK, fingerprint,
                                            window_offsets)
from tal_bench.traffic import subseed

FLOW_CHANNELS = 2


def flow_frames(seed: int, n: int, spatial: int, device: torch.device
                ) -> np.ndarray:
    """(n, spatial, spatial, 2) uint8 flow frames on the host, made on
    `device` from the seed: `traffic.frames`' noise and ramp on two
    channels."""
    g = traffic.generator(seed, 'flow_bank', device)
    noise = torch.randint(0, traffic.NOISE_LEVELS,
                          (n, spatial, spatial, FLOW_CHANNELS), generator=g,
                          device=device, dtype=torch.int16)
    r = traffic.ramp(n).to(device)[:, None, None, None]
    out = (noise + (255 - traffic.NOISE_LEVELS) // 2 + 1 + r).clamp(0, 255)
    return out.to(torch.uint8).cpu().numpy()


def cut_windows(frames: np.ndarray, offsets: List[int], clip: int,
                crop: int) -> torch.Tensor:
    """(W, C, clip, crop, crop) float32 windows of (T, H, W, C) uint8
    frames at `offsets`: centre crop, (x / 255) * 2 - 1, zero past the
    frames' end."""
    lo = (frames.shape[1] - crop) // 2
    data = torch.from_numpy(np.ascontiguousarray(
        frames[:, lo:lo + crop, lo:lo + crop]))
    out = torch.zeros((len(offsets), clip, crop, crop, frames.shape[-1]))
    for i, o in enumerate(offsets):
        part = data[o:o + clip].float()
        out[i, :part.shape[0]] = (part / 255.0) * 2.0 - 1.0
    return out.permute(0, 4, 1, 2, 3)


class FusedSource(traffic.VideoSource):
    """`traffic.VideoSource` with a flow bank beside the RGB bank; the
    flow view of each video it gives is kept by name in `flows` until the
    program takes it."""

    def __init__(self, t: Dict[str, Any], seed: int, device: torch.device,
                 bank: Optional[np.ndarray] = None,
                 flow_bank: Optional[np.ndarray] = None):
        super().__init__(t, seed, device, bank)
        self.flow_bank = flow_bank if flow_bank is not None else \
            flow_frames(seed, len(self.bank), self.bank.shape[1], device)
        self.flows: Dict[str, np.ndarray] = {}

    def next(self):
        name, data, n, fps, start = super().next()
        self.flows[name] = self.flow_bank[start:start + n - 1]
        return name, data, n, fps, start


class Runner(infer_packed.Runner):

    def __init__(self, cell, seed: int, device: torch.device,
                 trace: bool = False):
        super().__init__(cell, seed, device, trace)
        # the flow's fingerprint reads the last frame of each print stride
        frames, ys, xs = self.index
        self.flow_index = (frames + PRINT_STRIDE - 1, ys, xs)
        self.card_flow_index = tuple(t.to(device) for t in self.flow_index)

    def setup(self) -> None:
        from opental_torch import factory
        from opental_torch.infer.pipeline import InferencePipeline
        from opental_torch.tools.test import inference_dtype
        cfg = program.load_config(self.cell.config)
        self.cfg = cfg
        te = cfg.testing
        flags = factory.model_flags(cfg)
        models = []
        for channels, seed in ((None, 'weights_seed'),
                               (FLOW_CHANNELS, 'flow_weights_seed')):
            with torch.device(self.device):
                model = factory.build_model(
                    cfg, frame_num=self.clip, crop_size=self.crop,
                    dtype=inference_dtype(cfg), in_channels=channels)
            model = model.to(self.device)
            weights.seed_weights(model, self.cell.config_file[seed], 'infer')
            models.append(model)
        rgb, flow = models
        self.state_dict, self.flow_state_dict = (
            {k: v.detach().clone() for k, v in m.state_dict().items()}
            for m in models)
        self.pipe = InferencePipeline(
            rgb, clip_length=self.clip, stride=self.stride,
            crop_size=self.crop, conf_thresh=te.get('conf_thresh', 0.01),
            top_k=te.get('top_k', 5000), nms_sigma=te.get('nms_sigma', 0.5),
            use_edl=flags['use_edl'], os_head=flags['os_head'],
            use_gcpl=False, evidence=flags['evidence'], flow_model=flow,
            device_post=te.get('device_nms', True),
            n_candidates=te.get('n_candidates', 2048),
            device_ingest=te.get('device_ingest', True),
            device=self.device)
        self.streams: Dict[str, List[Dict[str, torch.Tensor]]] = {
            'rgb': [], 'flow': []}
        self.flow_prints: List[torch.Tensor] = []
        rgb.register_forward_pre_hook(self._pre)
        rgb.register_forward_hook(self._stream_post('rgb'))
        flow.register_forward_pre_hook(self._flow_pre)
        flow.register_forward_hook(self._stream_post('flow'))
        decode = self.pipe._decode

        def fused_decode(out):
            if self.recording:
                self.outputs.append({k: out[k] for k in DECODE_KEYS
                                     if out.get(k) is not None})
            return decode(out)
        self.pipe._decode = fused_decode
        run_videos = self.pipe.run_videos

        def with_flow(videos, **kw):
            return run_videos(((*v, self.source.flows.pop(v[0]))
                               for v in videos), **kw)
        self.pipe.run_videos = with_flow
        self.source = FusedSource(self.t, self.seed, self.device)
        warm = FusedSource(self.t, subseed(self.seed, 'warm'), self.device,
                           bank=self.source.bank,
                           flow_bank=self.source.flow_bank)
        videos, frames = [], 0
        while frames < self.capacity // 2:
            name, data, n, fps, _ = warm.next()
            videos.append((name, data, n, fps, warm.flows.pop(name)))
            frames += n
        run_videos(iter(videos), max_batch=self.max_batch,
                   frames_capacity=self.capacity)
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        self.rows = 0
        self.outputs = []
        self.streams = {'rgb': [], 'flow': []}
        self.flow_prints = []

    def _flow_pre(self, module, args):
        self.spans.enter('forward.flow')
        if self.recording:
            self.flow_prints.append(fingerprint(args[0],
                                                *self.card_flow_index))
        if self.calls is not None:
            self.calls.__enter__()

    def _stream_post(self, stream: str):
        def hook(module, args, out):
            if self.calls is not None:
                self.calls.__exit__(None, None, None)
            self.spans.exit()
            if self.recording:
                self.streams[stream].append({k: out[k] for k in DECODE_KEYS
                                             if out.get(k) is not None})
        return hook

    def counters(self) -> Dict[str, Any]:
        from tal_bench import counting
        out = super().counters()
        out['flops_per_unit'] += counting.model_flops(
            self.flow_config(), self.clip, self.crop, 1, train=False)
        return out

    # ------------------------------------------------------------ check

    def flow_config(self) -> Dict[str, Any]:
        return program.merged(self.cell.config,
                              {'model.in_channels': FLOW_CHANNELS})

    def rows_of(self, videos: List[int], flow: bool = True
                ) -> Dict[int, Optional[List[Tuple[int, int]]]]:
        """(forward, row) of each window of each of `videos` (None for a
        video where some window matches no row), found by the RGB input's
        fingerprint and, with `flow`, the flow input's too. The flow's
        reads end on the window's last frame: a video's tail window ends
        on its last frame, which the RGB stream holds and the flow stream
        (a frame shorter) zeroes, so another video's window over the same
        frames has the same RGB input and another flow input. The RGB
        stream's own outputs depend on its input alone."""
        prints = torch.cat([torch.cat([a, b], 1) if flow else a
                            for a, b in zip(self.prints, self.flow_prints)])
        where = [(f, r) for f, p in enumerate(self.prints)
                 for r in range(p.shape[0])]
        out: Dict[int, Optional[List[Tuple[int, int]]]] = {}
        for v in videos:
            want = self.window_prints(v)
            if flow:
                want = torch.cat([want, self.flow_window_prints(v)], 1)
            want = want.to(prints.device)
            best, rows = [], []
            for i in range(0, want.shape[0], REF_BLOCK):
                d = (want[i:i + REF_BLOCK, None] - prints[None]).abs() \
                    .amax(-1)
                b, r = d.min(dim=1)
                best.append(b)
                rows.append(r)
            out[v] = None if bool((torch.cat(best) > MATCH_TOL).any()) \
                else [where[r] for r in torch.cat(rows).tolist()]
        return out

    def video_outputs(self, videos: List[int], stream: str = 'fused',
                      rows=None
                      ) -> Dict[int, Optional[Dict[str, torch.Tensor]]]:
        """The program's fused outputs of each of `videos`' windows, or one
        stream's own ('rgb', 'flow'); None for a video where some window
        matches no row. Each forward packs both streams' rows alike.
        `rows`: `rows_of(videos, flow=stream != 'rgb')`, where already
        found."""
        outputs = self.outputs if stream == 'fused' else self.streams[stream]
        if rows is None:
            rows = self.rows_of(videos, flow=stream != 'rgb')
        return {v: None if rows[v] is None else {
            k: (torch.stack([outputs[f][k][r] for f, r in rows[v]])
                if k != 'priors' else outputs[0][k]) for k in outputs[0]}
            for v in videos}

    def flow_window_prints(self, v: int) -> torch.Tensor:
        """(W, D) fingerprints of offered video v's flow windows, read by
        the benchmark from the flow bank as `window_prints` reads the RGB
        bank, at `flow_index`'s frames, the flow's frames-valid a frame
        shorter."""
        info = self.offered[v]
        frames, ys, xs = self.flow_index
        bank = self.source.flow_bank
        lo = (bank.shape[1] - self.crop) // 2
        offs = torch.tensor(window_offsets(info['n'], self.clip,
                                           self.stride))
        t = offs[:, None] + frames[None]                  # (W, F)
        valid = t < info['n'] - 1
        t = torch.where(valid, t, 0) + info['start']
        data = torch.from_numpy(bank[
            t.reshape(-1, 1).numpy(), lo + ys.numpy()[None],
            lo + xs.numpy()[None]])
        x = (data.float() / 255.0) * 2.0 - 1.0            # (W*F, P, C)
        x = x.reshape(t.shape[0], t.shape[1], -1, x.shape[-1])
        x = torch.where(valid[:, :, None, None], x, 0.0)
        return x.permute(0, 3, 1, 2).reshape(t.shape[0], -1)

    def flow_windows_of(self, v: int) -> torch.Tensor:
        """(W, 2, clip, crop, crop) float32 flow windows of offered video
        v, cut by the benchmark from the flow bank (its flow a frame
        shorter than its RGB frames)."""
        info = self.offered[v]
        return cut_windows(
            self.source.flow_bank[info['start']:info['start'] + info['n']
                                  - 1],
            window_offsets(info['n'], self.clip, self.stride), self.clip,
            self.crop)

    def _flow_reference(self, v: int, dtype=None) -> Dict[str, torch.Tensor]:
        from tal_bench.reference import build
        if getattr(self, '_flow_ref', None) is None or \
                self._flow_ref_dtype != dtype:
            self._flow_ref = build.load(
                build.model(self.flow_config(), self.clip, self.crop, dtype),
                self.flow_state_dict, self.device).eval()
            self._flow_ref_dtype = dtype
        x = self.flow_windows_of(v)
        outs: List[Dict[str, torch.Tensor]] = []
        with torch.no_grad(), exact_f32():
            for i in range(0, x.shape[0], REF_BLOCK):
                o = self._flow_ref(x[i:i + REF_BLOCK].to(self.device))
                outs.append({k: o[k].float() for k in OUTPUT_KEYS
                             if o.get(k) is not None})
        return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}

    def reference_outputs(self, v: int, dtype=None, stream: str = 'fused'
                          ) -> Dict[str, torch.Tensor]:
        """The reference's outputs of offered video v's windows: both
        streams fused (`reference.decode.fuse_streams`), or one alone."""
        from tal_bench.reference.decode import fuse_streams
        if stream == 'flow':
            return self._flow_reference(v, dtype)
        rgb = super().reference_outputs(v, dtype)
        if stream == 'rgb':
            return rgb
        return fuse_streams(rgb, self._flow_reference(v, dtype))

    def check(self) -> List[Dict[str, Any]]:
        from tal_bench.reference import post
        limits = self.t['check']['limits']
        sample = self.sample()
        values = {'missing': sum(v['name'] not in self.results
                                 for v in self.offered), 'post_gap': 0.0}
        rows = {True: self.rows_of(sample), False: self.rows_of(sample, False)}
        for stream, key in (('fused', 'model_rel'), ('rgb', 'rgb_rel'),
                            ('flow', 'flow_rel')):
            outs = self.video_outputs(sample, stream, rows[stream != 'rgb'])
            values[key] = 0.0
            for v in sample:
                if outs[v] is None:
                    values[key] = math.inf
                    break
                values[key] = max(values[key], rel_gap(
                    outs[v], self.reference_outputs(v, stream=stream)))
                if stream == 'fused':
                    values['post_gap'] = max(values['post_gap'], post.gap(
                        self.results[self.offered[v]['name']],
                        self.reference_post(v, outs[v])))
            if values[key] == math.inf and stream == 'fused':
                values['post_gap'] = math.inf
        return [{'name': k, 'value': values[k], 'limit': lim}
                for k, lim in limits.items()]
