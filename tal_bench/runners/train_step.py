"""Training at the configuration's published batch size: the port's
`train.step.train_step` fed as `train.loop` feeds it
(`train.loop.build_dataset` over a seeded tree in the reference's
schema, written under TMPDIR; `dataset.batches` and
`data.prefetch.prefetch`), at an epoch past the EDL schedule's
`ibm_start`, so the full loss with the SSL pass runs.

Set-up builds the training state (the model's seeded weights, Adam, the
EDL state) and drives it through its first `check.steps` steps with the
window's own call and feed; that same state then runs the window. The
window: steps until `--seconds` have passed, a CUDA event after each;
the rate is over the synchronised wall time (the intervals between
consecutive events go to the run's summary on standard error).

The check (after the window, the program's state freed) follows two
stages with the plain reference step in float32 (TF32 off) on the same
batches (`Runner.numbers`):
* the start: set-up's steps, from the seeded weights, a fresh Adam and
  a fresh EDL state;
* the timed steps: the window's first `check.timed_steps` steps, from
  the training state as the window found it (parameters and buffers,
  Adam's moments and step count, the EDL state; device copies taken at
  the window's start, at well under a step's cost), so that whatever
  takes over the step after warm-up is compared too. Its numbers are
  named `timed.<number>`.
Each stage compares:
* `feat_rel`: its first main pass's frame-level features;
* `loss_gap`, `loss1_gap`: each step's loss, the first step's;
* `grad_gap`: its first gradient as Adam got it (from Adam's first
  moment before and after that step), by the worst leaf;
* `change_gap`: the change of the parameters and of the EDL state over
  its steps, by the worst leaf; leaves whose reference gradient is under
  a thousandth of the median leaf's are left out.
The traffic mix gives each configuration the numbers it compares and
their limits.
"""

from __future__ import annotations

import shutil
import statistics
import tempfile
import time
from typing import Any, Dict, List, Optional

import torch

from tal_bench import program, traffic, weights
from tal_bench.compare import exact_f32, leaf_gaps, norms
from tal_bench.trace import OpCalls, Spans

BETA1 = 0.9
# the main pass's frame-level features (the deconv stack's start / end
# halves and both proposal branches' level-0 lr features)
FEATURE_KEYS = ('start', 'end', 'start_loc_prop', 'end_loc_prop',
                'start_conf_prop', 'end_conf_prop')
NEGLIGIBLE = 1e-3      # of the median leaf's reference gradient norm


def p90(xs: List[float]) -> float:
    """The 90th percentile (statistics' inclusive quantiles)."""
    return statistics.quantiles(xs, n=10, method='inclusive')[8]


class Runner:
    kind = 'train'

    def __init__(self, cell, seed: int, device: torch.device,
                 trace: bool = False):
        self.cell, self.seed, self.device = cell, seed, device
        self.trace = trace
        self.t = cell.traffic
        cfg = cell.config
        self.clip = cfg['dataset']['training']['clip_length']
        self.crop = cfg['dataset']['training']['crop_size']
        self.arch = cfg.get('model', {}).get('arch', 'thumos')
        self.batch = int(cfg['training']['batch_size'])
        self.epoch = int(self.t['epoch'])
        self.n_check = int(self.t['check']['steps'])
        self.n_timed = int(self.t['check']['timed_steps'])
        self.calls: Optional[OpCalls] = None
        self.spans = Spans()
        self.keep_outputs: Optional[str] = None
        self.outputs: Dict[str, Dict[str, torch.Tensor]] = {}
        self.timed_batches: List[Dict[str, torch.Tensor]] = []
        self.timed_losses: List[torch.Tensor] = []
        self.root: Optional[str] = None

    # ----------------------------------------------------------- set-up

    def setup(self) -> None:
        from opental_torch import factory
        from opental_torch.data.prefetch import prefetch
        from opental_torch.losses.edl import EDLState
        from opental_torch.train.loop import build_dataset
        from opental_torch.train.step import (TrainState, make_anet_optimizer,
                                              make_optimizer)
        self.root = tempfile.mkdtemp(prefix='tal_bench_tree_')
        tree = self.t['tree'][self.arch]
        num_known = self.cell.config['dataset']['num_classes'] - 1
        make = traffic.anet_tree if self.arch == 'anet' else \
            traffic.thumos_tree
        self.overrides = make(self.root, self.seed, tree, num_known,
                              int(tree['spatial']), self.device)
        cfg = program.load_config(self.cell.config, self.overrides)
        self.cfg = cfg
        with torch.device(self.device):
            model = factory.build_model(cfg, frame_num=self.clip,
                                        crop_size=self.crop)
        model = model.to(self.device)
        weights.seed_weights(model, self.seed, 'train')
        self.sd0 = {k: v.detach().clone()
                    for k, v in model.state_dict().items()}
        tr = cfg.training
        make_opt = make_anet_optimizer if self.arch == 'anet' \
            else make_optimizer
        self.loss_cfg = factory.build_loss_config(cfg)
        self.weights = factory.build_loss_weights(cfg)
        self.state = TrainState(
            model=model,
            optimizer=make_opt(model, tr['learning_rate'],
                               tr['weight_decay']),
            edl_state=EDLState.create(self.loss_cfg.edl, self.device))
        self.edl0 = self.state.edl_state
        dataset = build_dataset(cfg, self.arch, self.clip, self.crop,
                                traffic.subseed(self.seed, 'dataset'))
        self.dataset = dataset

        def epochs():
            while True:
                yield from dataset.batches(self.batch)

        self._feed_cm = prefetch(epochs(), self.device, depth=2)
        self.feed = iter(self._feed_cm)
        model.register_forward_pre_hook(self._pre)
        model.register_forward_hook(self._post)
        # the first steps: warm-up and the checked steps, one object
        self.batches, self.losses = [], []
        for i in range(self.n_check):
            batch = next(self.feed)
            self.batches.append(batch)
            # the first main pass's outputs
            self.keep_outputs = 'start' if i == 0 else None
            self.losses.append(self._step(batch)['cost'])
            if i == 0:
                # the first gradient as Adam got it: its first moment
                # (none where the step left no optimizer state)
                self.g1 = {k: m / (1 - BETA1)
                           for k, m in self._moment('exp_avg').items()}
        self.p_n = {name: p.detach().clone()
                    for name, p in model.named_parameters()}
        self.edl_n = _copy_edl(self.state.edl_state)
        # the state the window starts from, for the timed steps' check
        self.at_window = self._snapshot()
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    def _moment(self, key: str) -> Dict[str, torch.Tensor]:
        """A copy of Adam's `key` state of every parameter (zeros where
        the optimizer holds none)."""
        opt = self.state.optimizer
        return {name: opt.state.get(p, {}).get(
            key, torch.zeros_like(p)).detach().clone()
            for name, p in self.state.model.named_parameters()}

    def _snapshot(self) -> Dict[str, Any]:
        """Device copies of the training state as it stands: the model's
        parameters and buffers, Adam's moments and step count, the EDL
        state."""
        opt = self.state.optimizer
        steps = [int(st['step']) for st in opt.state.values()
                 if 'step' in st]
        edl_state = self.state.edl_state
        return {'sd': {k: v.detach().clone()
                       for k, v in self.state.model.state_dict().items()},
                'exp_avg': self._moment('exp_avg'),
                'exp_avg_sq': self._moment('exp_avg_sq'),
                'step': max(steps, default=0),
                'edl': tuple(t.detach().clone() for t in edl_state)}

    def _timed_end(self) -> None:
        """The state after the window's checked steps."""
        self.timed_p = {name: p.detach().clone()
                        for name, p in self.state.model.named_parameters()}
        self.timed_edl = _copy_edl(self.state.edl_state)

    def _step(self, batch):
        from opental_torch.train.step import train_step
        with self.spans.span('train_step'):
            return train_step(self.state, self.loss_cfg, self.weights, batch,
                              self.epoch)

    def _pre(self, module, args):
        self.spans.enter('forward')

    def _post(self, module, args, out):
        self.spans.exit()
        if self.keep_outputs is not None:
            self.outputs[self.keep_outputs] = {
                k: out[k].detach() for k in FEATURE_KEYS
                if out.get(k) is not None}
            self.keep_outputs = None

    # ----------------------------------------------------------- window

    def window(self, seconds: float) -> Dict[str, float]:
        cuda = self.device.type == 'cuda'
        marks, costs = [], []
        steps = 0
        capture = int(self.t.get('capture_steps', 2)) if self.trace else 0
        if self.trace:
            self.calls = OpCalls()
        t0 = time.perf_counter()
        if cuda:
            first = torch.cuda.Event(enable_timing=True)
            first.record()
            marks.append(first)
        while time.perf_counter() - t0 < seconds:
            with self.spans.span('feed'):
                batch = next(self.feed)
            checked = steps < self.n_timed
            if checked:
                self.timed_batches.append(batch)
                self.keep_outputs = 'timed' if steps == 0 else None
            if steps < capture:
                with self.calls:
                    costs.append(self._step(batch)['cost'])
            else:
                costs.append(self._step(batch)['cost'])
            if checked:
                with self.spans.span('check_copy'):
                    if steps == 0:
                        self.timed_m1 = self._moment('exp_avg')
                    if steps == self.n_timed - 1:
                        self._timed_end()
            steps += 1
            if cuda:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                marks.append(ev)
        if 0 < steps < self.n_timed:
            self._timed_end()
        if cuda:
            torch.cuda.synchronize(self.device)
        self.timed_losses = costs[:self.n_timed]
        wall = time.perf_counter() - t0
        self.steps, self.wall = steps, wall
        self.bad_steps = int((~torch.isfinite(torch.stack(costs))).sum()) \
            if costs else 0
        self.gaps = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        return {'train_clips_per_s': steps * self.batch / wall}

    def summary(self) -> Dict[str, Any]:
        """The window's counts, its step intervals' median and 90th
        percentile (from the CUDA events), and every number the check
        worked out, compared or not."""
        tail = len(self.gaps) >= 10
        return {'wall_s': self.wall, 'steps': self.steps,
                'step_ms_median': (statistics.median(self.gaps)
                                   if self.gaps else None),
                'step_ms_p90': p90(self.gaps) if tail else None,
                'numbers': getattr(self, 'all_numbers', None)}

    def attempts(self):
        """(steps in the window, steps whose loss is not finite)."""
        return self.steps, self.bad_steps

    def counters(self) -> Dict[str, Any]:
        from tal_bench import counting
        flops = counting.model_flops(self.cell.config, self.clip, self.crop,
                                     self.batch, train=True,
                                     ssl=self.weights.ssl > 0)
        return {'steps': self.steps, 'flops_per_unit': flops,
                'calls': self.calls}

    # ------------------------------------------------------------ check

    def release(self) -> None:
        """Free the program's state and the feed; keep what the check
        reads."""
        self._feed_cm.close()
        self.state = self.dataset = self.feed = None
        if self.root is not None:
            shutil.rmtree(self.root, ignore_errors=True)
            self.root = None
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()

    def reference_steps(self, stage: str = 'start', dtype=None,
                        tf32: bool = False, batches=None):
        """The plain reference's steps of `stage` ('start': set-up's, from
        the seeded weights, a fresh Adam and EDL state; 'timed': the
        window's first, from the state the window started from) on the
        same batches (or `batches`): (losses, first gradients as Adam
        gets them, first raw gradients, parameters before and after, EDL
        state after, the first main pass's outputs). `tf32` lets its
        float32 convolutions and products take TF32, as the program's
        do."""
        from tal_bench.reference import build, edl, step
        cfg = program.merged(self.cell.config, self.overrides)
        at = self.at_window if stage == 'timed' else None
        model = build.load(build.model(cfg, self.clip, self.crop, dtype),
                           at['sd'] if at else self.sd0, self.device)
        lr, wd = step.lr_of(cfg['training'])
        adam = step.make_adam(model, lr, wd)
        loss_cfg = build.loss_config(cfg)
        weights_ = build.loss_weights(cfg)
        if at:
            for name, p in model.named_parameters():
                adam.m[id(p)].copy_(at['exp_avg'][name])
                adam.v[id(p)].copy_(at['exp_avg_sq'][name])
            adam.t = at['step']
            state = edl.EDLState(*(t.clone() for t in at['edl']))
        else:
            state = edl.EDLState.create(loss_cfg.edl, self.device)
        if batches is None:
            batches = self.timed_batches if at else self.batches
        p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
        losses, g1, raw1, out1 = [], None, None, None
        with exact_f32(tf32):
            for i, batch in enumerate(batches):
                metrics, state, grads, out = step.step(
                    model, adam, loss_cfg, weights_, batch, state,
                    self.epoch)
                losses.append(float(metrics['cost']))
                if i == 0:
                    raw1, out1 = grads, out
                    g1 = {n: grads[n] + wd * p0[n] for n in grads}
        pn = {n: p.detach().clone() for n, p in model.named_parameters()}
        if out1 is not None:
            out1 = {k: v.float() for k, v in out1.items()
                    if k in FEATURE_KEYS}
        return losses, g1, raw1, p0, pn, state, out1

    def program_side(self, stage: str = 'start'):
        """The program's readings of `stage`, in `reference_steps`' order
        (its first raw gradients and parameters before are the
        reference's business and left None)."""
        if stage == 'start':
            return ([float(x) for x in self.losses], self.g1, None, None,
                    self.p_n, self.edl_n, self.outputs.get('start', {}))
        if not self.timed_batches:
            return None
        m0 = self.at_window['exp_avg']
        g1 = {k: (m - BETA1 * m0[k]) / (1 - BETA1)
              for k, m in self.timed_m1.items()}
        return ([float(x) for x in self.timed_losses], g1, None, None,
                self.timed_p, self.timed_edl, self.outputs.get('timed', {}))

    def program_numbers(self) -> Dict[str, Any]:
        """Every number of both stages for the program, limited or
        not."""
        nums = self.numbers(self.reference_steps('start'))
        nums.update(self.numbers(self.reference_steps('timed'),
                                 stage='timed'))
        return nums

    def check(self) -> List[Dict[str, Any]]:
        """The numbers the traffic mix gives a limit for this cell's
        configuration, each against it."""
        limits = self.t['check']['limits'][self.cell.entry['config']]
        nums = self.program_numbers()
        self.all_numbers = nums
        return [{'name': k, 'value': nums[k], 'limit': v}
                for k, v in limits.items()]

    def numbers(self, ref, prog=None, stage: str = 'start'
                ) -> Dict[str, Any]:
        """The numbers of the program's steps of `stage` (or of `prog`,
        another run of the reference standing in its place) against the
        reference's: `feat_rel`, the frame-level features of the first
        main pass (relative l2 gap, the features taken together);
        `loss_gap`, each step's loss, and `loss1_gap`, the first's
        (relative); `grad_gap`, the first gradient as Adam got it, and
        `change_gap`, the change of the parameters and of the EDL state
        over the stage's steps, both by the worst leaf; `where` names
        the worst leaves. The timed stage's names take the prefix
        `timed.`; where the window ran no step, its numbers are
        infinite."""
        pre = 'timed.' if stage == 'timed' else ''
        if prog is None:
            prog = self.program_side(stage)
        if prog is None or not ref[0]:
            return {pre + k: float('inf') for k in
                    ('feat_rel', 'loss_gap', 'loss1_gap', 'grad_gap',
                     'change_gap')}
        losses, g1, raw1, p0, pn, edl_n, out1 = ref
        p_losses, p_g1, _, _, p_pn, p_edl, p_out = prog
        gaps = [abs(a - b) / max(abs(b), 1e-30)
                for a, b in zip(p_losses, losses)]
        if len(p_losses) != len(losses):
            gaps.append(float('inf'))
        leaves = sorted(g1)
        grad = leaf_gaps(norms(p_g1), norms(g1), leaves)
        raw = norms(raw1)
        med = statistics.median(raw[k] for k in leaves)
        moved = [k for k in leaves if raw[k] >= NEGLIGIBLE * med]
        d_ref = {k: pn[k] - p0[k] for k in moved}
        d_prog = {k: p_pn[k].to(pn[k].device) - p0[k] for k in moved}
        base = (self.at_window['edl'][0] if stage == 'timed'
                else self.edl0.weight_accum).to(edl_n.weight_accum.device)
        d_ref['edl.weight_accum'] = edl_n.weight_accum - base
        d_prog['edl.weight_accum'] = p_edl.weight_accum.to(base.device) \
            - base
        change = leaf_gaps(norms(d_prog), norms(d_ref), sorted(d_ref))
        g_at = max(grad, key=grad.get)
        c_at = max(change, key=change.get)
        return {pre + 'feat_rel': diff_norm(p_out, out1, sorted(out1)),
                pre + 'loss_gap': max(gaps), pre + 'loss1_gap': gaps[0],
                pre + 'grad_gap': grad[g_at],
                pre + 'change_gap': change[c_at],
                pre + 'where': {'grad': g_at, 'change': c_at,
                                'left_out': len(leaves) - len(moved)}}


def _copy_edl(state):
    """A device copy of an EDL state (a named tuple of tensors)."""
    return type(state)(*(t.detach().clone() for t in state))


def diff_norm(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keys: List[str]) -> float:
    """||p - r|| / ||r|| over the named tensors taken together (infinite
    where the program's is missing or of another shape)."""
    if any(k not in prog or prog[k].shape != ref[k].shape for k in keys):
        return float('inf')
    num = sum(float((prog[k].to(ref[k].device).double()
                     - ref[k].double()).square().sum()) for k in keys)
    den = sum(float(ref[k].double().square().sum()) for k in keys)
    return (num / max(den, 1e-300)) ** 0.5
