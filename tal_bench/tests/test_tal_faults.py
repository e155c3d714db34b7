"""The check of `correct`, driven through a whole run at a tiny size on
the CPU (the harness's look for a card skipped), with the timed path
broken underneath: each fault a cell can have makes `correct` false, and
the sound run and the lower-precision control read as they should.

Faults: an answer altered where it is produced (inference: a proposal's
score as post-processing returns it; a model output as the forward
returns it); a step that returns its state unchanged (training); half
of the batch left out, the mean taken over the rest (training at batch
2). The exchange between chips does not exist in these one-card cells.
"""

import copy

import pytest
import torch

from tal_bench import control, run
from tal_bench.tests import tiny

CPU = torch.device('cpu')
SEED = 2 ** 31 + 21


@pytest.fixture(scope='module')
def pkg(tmp_path_factory):
    torch.set_num_threads(2)
    return tiny.build(str(tmp_path_factory.mktemp('tiny') / 'pkg'))


def one_run(pkg, workload, seconds=2.0, trace=0, prepare=None):
    """A whole run of `workload` with `prepare(runner)` applied after
    set-up (the fault), as run.run drives it."""
    bench, path = pkg
    from tal_bench import spec
    cell = spec.Cell(bench, workload, path)
    module = cell.runner_module()
    real = module.Runner

    class Faulty(real):
        def setup(self):
            if prepare is not None and getattr(prepare, 'before', False):
                prepare(self)
            super().setup()
            if prepare is not None and not getattr(prepare, 'before',
                                                   False):
                prepare(self)

    module.Runner = Faulty
    orig = cell.runner_module
    cell.runner_module = lambda: module
    try:
        args = run.parse(['--workload', workload, '--seed', str(SEED),
                          '--seconds', str(seconds), '--trace', str(trace)])
        return run_cell(args, cell)
    finally:
        cell.runner_module = orig


def run_cell(args, cell):
    """run.run for a prepared cell."""
    from tal_bench import spec
    saved = spec.Cell
    spec.Cell = lambda *a, **k: cell
    try:
        return run.run(args, device=CPU, bench={}, pkg='')
    finally:
        spec.Cell = saved


def test_sound_inference_run_is_correct(pkg):
    out = one_run(pkg, 'thumos14.infer.test_mix', trace=1)
    assert out['correct'], out['checks']
    assert list(out)[-1] == 'checks'
    assert out['metrics']['forward_fill_pct']['value'] <= 100.0


def test_altered_answer_fails(pkg):
    def alter(runner):
        post = runner.pipe.post_process_on_device

        def altered(*a, **k):
            props = post(*a, **k)
            if props:
                props[0] = dict(props[0], score=props[0]['score'] * 0.5)
            return props
        runner.pipe.post_process_on_device = altered
    out = one_run(pkg, 'thumos14.infer.test_mix', prepare=alter)
    assert not out['correct']
    assert out['checks']['post_gap']['value'] > \
        out['checks']['post_gap']['limit']


def test_another_packing_is_still_correct(pkg):
    """The check finds each window's outputs by content, so a scheduler
    that packs its flushes otherwise is judged by its outputs alone."""
    def repack(runner):
        run_videos = runner.pipe.run_videos

        def other(videos, max_batch, frames_capacity):
            return run_videos(videos, max_batch=max_batch // 2 + 1,
                              frames_capacity=frames_capacity * 2)
        runner.pipe.run_videos = other
    out = one_run(pkg, 'thumos14.infer.test_mix', prepare=repack)
    assert out['correct'], out['checks']


def test_window_prints_read_the_model_input(pkg):
    """The fingerprints the benchmark reads from a video's frames are
    those of the windows it cuts for the reference."""
    from tal_bench import spec, traffic
    from tal_bench.runners import infer_packed
    bench, path = pkg
    cell = spec.Cell(bench, 'thumos14.infer.long', path)
    runner = cell.runner_module().Runner(cell, SEED, CPU)
    runner.source = traffic.VideoSource(cell.traffic, SEED, CPU)
    name, data, n, fps, start = runner.source.next()
    runner.offered = [{'name': name, 'n': n, 'fps': fps, 'start': start}]
    want = infer_packed.fingerprint(runner.windows_of(0), *runner.index)
    got = runner.window_prints(0)
    assert got.shape == want.shape and got.shape[0] > 1
    assert torch.equal(got, want)
    # every window's print differs from every other's
    d = (got[:, None] - got[None]).abs().amax(-1)
    assert bool((d + torch.eye(len(got)) * 9 > infer_packed.MATCH_TOL)
                .all())


def test_altered_model_output_fails(pkg):
    def alter(runner):
        def hook(module, args, out):
            out['conf'].mul_(1.5)
        runner.pipe.model.register_forward_hook(hook, prepend=True)
    out = one_run(pkg, 'thumos14.infer.long', prepare=alter)
    assert not out['correct']
    assert out['checks']['model_rel']['value'] > \
        out['checks']['model_rel']['limit']


def _train_step_patch(monkeypatch, make):
    import opental_torch.train.step as step
    monkeypatch.setattr(step, 'train_step', make(step.train_step))


def test_unchanged_state_fails(pkg, monkeypatch):
    def make(real):
        def unchanged(state, *a, **k):
            params = [p.detach().clone() for p in state.model.parameters()]
            opt = copy.deepcopy(state.optimizer.state_dict())
            edl, n = state.edl_state, state.step
            out = real(state, *a, **k)
            with torch.no_grad():
                for p, q in zip(state.model.parameters(), params):
                    p.copy_(q)
            state.optimizer.load_state_dict(opt)
            state.edl_state, state.step = edl, n
            return out
        return unchanged
    _train_step_patch(monkeypatch, make)
    out = one_run(pkg, 'thumos14.train.bs1')
    assert not out['correct']
    assert out['checks']['change_gap']['value'] > \
        out['checks']['change_gap']['limit']


def test_unchanged_state_after_warm_up_fails(pkg, monkeypatch):
    """A step that goes wrong only once set-up's steps have run (as a
    replayed graph or a fused update that takes over after warm-up
    would) is caught by the timed steps' check."""
    def make(real):
        calls = []

        def late(state, *a, **k):
            calls.append(1)
            if len(calls) <= 3:
                return real(state, *a, **k)
            params = [p.detach().clone() for p in state.model.parameters()]
            out = real(state, *a, **k)
            with torch.no_grad():
                for p, q in zip(state.model.parameters(), params):
                    p.copy_(q)
            return out
        return late
    _train_step_patch(monkeypatch, make)
    out = one_run(pkg, 'thumos14.train.bs1')
    checks = out['checks']
    assert not out['correct']
    assert checks['change_gap']['value'] <= checks['change_gap']['limit']
    assert checks['timed.change_gap']['value'] > \
        checks['timed.change_gap']['limit']


def test_half_batch_fails(pkg, monkeypatch):
    def make(real):
        def half(state, loss_cfg, weights, batch, epoch, **k):
            n = next(iter(batch.values())).shape[0]
            return real(state, loss_cfg, weights,
                        {key: v[:n // 2] for key, v in batch.items()},
                        epoch, **k)
        return half
    _train_step_patch(monkeypatch, make)
    out = one_run(pkg, 'anet.train.bs2')
    assert not out['correct'], out['checks']


def test_sound_training_run_is_correct(pkg):
    out = one_run(pkg, 'anet.train.bs2', trace=1)
    assert out['correct'], out['checks']
    assert 'launches_per_step' in out['metrics']


@pytest.mark.parametrize('workload', ['thumos14.infer.test_mix',
                                      'thumos14.train.bs1'])
def test_the_control_fails(pkg, workload):
    """The reference in the precision below the configuration's, in the
    program's place, reads above a limit of the cell."""
    bench, path = pkg
    from tal_bench import spec
    cell = spec.Cell(bench, workload, path)
    runner = cell.runner_module().Runner(cell, SEED, CPU)
    runner.setup()
    runner.window(1.0)
    runner.release()
    limits = cell.traffic['check']['limits']
    limits = limits.get(cell.entry['config'], limits)
    if runner.kind == 'infer':
        low = control.infer_control(runner)
    else:
        low = control.train_control(runner)['control']
    assert any(low[k] > limits[k] for k in limits if k in low), \
        (low, limits)
