"""Rank workers, and the multichip dryrun of the data mesh.

`Ranks` starts one process per rank (the `spawn` method), each of
which joins a mesh through a `file://` rendezvous, runs a list of jobs
and writes what they return; the caller reads every rank's results.
The jobs are the entry points a user calls on a mesh:

- 'train': `train_step` under `make_data_parallel` (Adam at `LR`, the
  spec's weight decay) on this rank's rows of a global numpy batch, for
  a list of epochs; returns the metrics of each step, the last step's
  gradients, the parameters, the buffers (BN running statistics), the
  EDL state and the pool kernels' launches;
- 'time_train': the same step timed (steps per rank, ms, peak memory);
- 'infer': an `InferencePipeline(mesh=...)` method on in-memory videos;
- 'run_test': `tools.test.run_test(cfg, mesh=...)`; these two return
  B1's launches and B6's (the I3D's 3D max pool) besides their results;
- 'train_cli': `tools.train.main(argv)` (the CLI with --use_mesh takes
  the group the worker joined);
- 'backends': TF32 off and cuDNN deterministic (`exact`), or PyTorch's
  defaults, for the jobs after it.

`dryrun_multichip(n)` is the counterpart of the JAX package's
`__graft_entry__.dryrun_multichip`: on n ranks, the full OpenTAL-final
step with remat and the PU actionness loss, then mesh inference across
several flushes (a video of more windows than `max_batch`, a padded
tail) and a fusion leg (flow one frame short), each held against one
device. The workers live here, in the package, so that the processes a
test or `chip_smoke.py` spawns import neither JAX nor the test module.

    python -m opental_torch.parallel.dryrun [n] [--device cpu|cuda]
"""

from __future__ import annotations

import argparse
import copy
import os
import tempfile
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.multiprocessing as mp

from opental_torch.parallel.mesh import Mesh, make_mesh, shard_batch

Job = Tuple[str, Dict[str, Any]]


def rank_device(device: str, rank: int) -> str:
    """A rank's device: the CPU, or card rank % cards (ranks share the
    cards when there are more ranks than cards)."""
    if device == 'cpu':
        return 'cpu'
    return f'cuda:{rank % torch.cuda.device_count()}'


def rank_backend(device: str, world: int) -> str:
    """gloo on the CPU and where ranks share a card (NCCL refuses two
    ranks on one device), NCCL otherwise."""
    if device == 'cpu' or world > torch.cuda.device_count():
        return 'gloo'
    return 'nccl'


def _launches() -> Tuple[int, int, int]:
    """B1's forward and backward launches and B6's (the I3D's 3D max
    pool) so far in this process."""
    from opental_torch.ops import boundary_pool_cuda, max_pool3d_cuda
    return (boundary_pool_cuda.LAUNCHES, boundary_pool_cuda.BWD_LAUNCHES,
            max_pool3d_cuda.LAUNCHES)


def _sync(mesh: Mesh) -> None:
    if mesh.device.type == 'cuda':
        torch.cuda.synchronize(mesh.device)


def _own(model: torch.nn.Module) -> torch.nn.Module:
    """This rank's own copy of a model it was handed: torch's spawn
    pickler passes CPU tensors in shared memory, so without a copy the
    ranks would update one set of weights and statistics."""
    return copy.deepcopy(model)


LR = 1e-5          # the optimizer's learning rate in every mesh job


def _train_state(mesh: Mesh, spec: Dict[str, Any]):
    from opental_torch.losses.edl import EDLState
    from opental_torch.train.step import (TrainState, make_anet_optimizer,
                                          make_data_parallel,
                                          make_optimizer)
    model = _own(spec['model']).to(mesh.device)
    make_opt = make_anet_optimizer if model.arch == 'anet' \
        else make_optimizer
    edl = spec['loss_cfg'].edl
    state = TrainState(
        model=model, optimizer=make_opt(model, LR, spec['wd']),
        edl_state=(None if edl is None
                   else EDLState.create(edl, mesh.device)))
    return make_data_parallel(state, mesh)


def _rows(mesh: Mesh, batch: Dict[str, np.ndarray]
          ) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(mesh.device)
            for k, v in shard_batch(mesh, batch).items()}


def step_record(state, metrics: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """A train state after a step, on the host: the step's metrics (a
    list of one), the parameters' gradients, the parameters, the buffers
    (BN running statistics) and the EDL state."""
    model = state.model
    return {
        'metrics': [{k: float(v) for k, v in metrics.items()}],
        'grads': {k: (torch.zeros_like(v) if v.grad is None else v.grad
                      ).detach().cpu() for k, v in model.named_parameters()},
        'params': {k: v.detach().cpu() for k, v in
                   model.named_parameters()},
        'buffers': {k: v.detach().cpu() for k, v in model.named_buffers()},
        'edl': (None if state.edl_state is None else
                {k: v.detach().cpu() for k, v in
                 state.edl_state._asdict().items()}),
    }


def _job_train(mesh: Mesh, spec: Dict[str, Any]) -> Dict[str, Any]:
    """`step_record` after a step per epoch of `spec['epochs']`, with
    every step's metrics and the pool kernels' launches."""
    from opental_torch.train.step import train_step
    state = _train_state(mesh, spec)
    rows = _rows(mesh, spec['batch'])
    before = _launches()
    metrics = []
    for epoch in spec['epochs']:
        m = train_step(state, spec['loss_cfg'], spec['weights'], rows,
                       epoch)
        metrics.append({k: float(v) for k, v in m.items()})
    after = _launches()
    out = step_record(state, m)
    out.update(metrics=metrics,
               launches=(after[0] - before[0], after[1] - before[1]))
    return out


def _job_time_train(mesh: Mesh, spec: Dict[str, Any]) -> Dict[str, Any]:
    """Step time on this rank: 2 warm steps, then 3 timed ones ending
    in a synchronize, and the peak memory of the timed ones."""
    from opental_torch.train.step import train_step
    state = _train_state(mesh, spec)
    rows = _rows(mesh, spec['batch'])

    def step():
        train_step(state, spec['loss_cfg'], spec['weights'], rows,
                   spec['epochs'][0])

    for _ in range(2):
        step()
    _sync(mesh)
    cuda = mesh.device.type == 'cuda'
    if cuda:
        torch.cuda.reset_peak_memory_stats(mesh.device)
    t0 = time.perf_counter()
    for _ in range(3):
        step()
    _sync(mesh)
    ms = (time.perf_counter() - t0) * 1e3 / 3
    peak = (torch.cuda.max_memory_allocated(mesh.device) / 2 ** 30
            if cuda else None)
    return {'ms': ms, 'peak_gib': peak}


def _job_infer(mesh: Mesh, spec: Dict[str, Any]) -> Dict[str, Any]:
    """`spec['method']` of a mesh pipeline ('run_videos': the videos and
    `kwargs`; 'run_video': each video alone), on the in-memory videos
    (name, frames, sample_count, fps[, flow frames])."""
    from opental_torch.infer.pipeline import InferencePipeline
    flow = spec.get('flow')
    pipe = InferencePipeline(_own(spec['model']),
                             flow_model=None if flow is None else _own(flow),
                             mesh=mesh, **spec['pipe'])
    before = _launches()
    _sync(mesh)
    t0 = time.perf_counter()
    if spec['method'] == 'run_videos':
        results = pipe.run_videos(iter(spec['videos']), **spec['kwargs'])
    else:
        results = {v[0]: pipe.run_video(v[1], v[2], v[3],
                                        flow_data=(v[4] if len(v) > 4
                                                   else None),
                                        **spec['kwargs'])
                   for v in spec['videos']}
    _sync(mesh)
    after = _launches()
    return {'results': results, 'seconds': time.perf_counter() - t0,
            'launches': after[0] - before[0],
            'pool3d_launches': after[2] - before[2]}


def _job_run_test(mesh: Mesh, spec: Dict[str, Any]) -> Dict[str, Any]:
    """run_test of a config file with overrides; rank 0 writes the JSON."""
    from opental_torch.config import load_config
    from opental_torch.tools.test import run_test
    cfg = load_config(spec['config'], overrides=spec.get('overrides'))
    before = _launches()
    _sync(mesh)
    t0 = time.perf_counter()
    path = run_test(cfg, mesh=mesh)
    _sync(mesh)
    after = _launches()
    return {'path': path, 'seconds': time.perf_counter() - t0,
            'launches': after[0] - before[0],
            'pool3d_launches': after[2] - before[2]}


def _job_train_cli(mesh: Mesh, spec: Dict[str, Any]) -> Dict[str, Any]:
    from opental_torch.tools import train as train_cli
    before = _launches()
    train_cli.main(list(spec['argv']))
    after = _launches()
    return {'launches': (after[0] - before[0], after[1] - before[1])}


def _job_backends(mesh: Optional[Mesh], spec: Dict[str, Any]
                  ) -> Dict[str, Any]:
    """For the jobs after it: with `exact`, TF32 off and cuDNN
    deterministic; without, PyTorch's defaults."""
    exact = spec['exact']
    torch.backends.cudnn.allow_tf32 = not exact
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = exact
    return {}


JOBS = {'train': _job_train, 'time_train': _job_time_train,
        'infer': _job_infer, 'run_test': _job_run_test,
        'train_cli': _job_train_cli, 'backends': _job_backends}


def _rank_main(rank: int, world: int, init_method: str, device: str,
               jobs: Sequence[Job], out_dir: str) -> None:
    """One rank, on one CPU thread: join the mesh, run the jobs, write
    their results to `out_dir/rank<r>.pt`, leave the group."""
    torch.set_num_threads(1)
    if device != 'cpu':
        from opental_torch.ops import _build
        _build.build_all()
    mesh = make_mesh(world, rank, local_rank=rank,
                     init_method=init_method,
                     backend=rank_backend(device, world),
                     device=rank_device(device, rank))
    try:
        results = []
        for kind, spec in jobs:
            results.append(JOBS[kind](mesh, spec))
            if mesh.device.type == 'cuda':
                # ranks may share the card: hand back what the job cached
                torch.cuda.empty_cache()
        torch.save(results, os.path.join(out_dir, f'rank{rank}.pt'))
    finally:
        mesh.close()


class Ranks:
    """`world` rank processes running `jobs`, started at once; `results()`
    waits for them and returns each rank's list of job results. The
    rendezvous file and the results live in a temporary directory (under
    `root` when given) that `results()` removes."""

    def __init__(self, world: int, jobs: Sequence[Job],
                 device: str = 'cpu', root: Optional[str] = None):
        self.world = world
        self._dir = tempfile.TemporaryDirectory(dir=root)
        init = 'file://' + os.path.join(self._dir.name, 'rendezvous')
        self._ctx = mp.start_processes(
            _rank_main, args=(world, init, device, list(jobs),
                              self._dir.name),
            nprocs=world, join=False, start_method='spawn')

    def results(self, timeout: float = 1800.0) -> List[List[Any]]:
        """Every rank's job results, in rank order. Raises (and stops
        the other ranks) if a rank fails or the ranks outlast
        `timeout` seconds."""
        try:
            deadline = time.monotonic() + timeout
            while not self._ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f'ranks still running after '
                                       f'{timeout} s')
            return [torch.load(os.path.join(self._dir.name, f'rank{r}.pt'),
                               weights_only=False)
                    for r in range(self.world)]
        finally:
            for p in self._ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
            self._dir.cleanup()


# --------------------------------------------------------------- checks

# A gradient tensor against another step's, as a share of the tensor's
# norm and of its largest element. With train-mode BN, which amplifies
# rounding, sound steps read up to 0.035 / 0.164 (2 CPU ranks against
# the JAX mesh), 0.009 / 0.082 (against one process, remat) and 0.029 /
# 0.127 (2 ranks on an H100 against one process); with BN frozen 0.005 /
# 0.010. Planted faults read 0.5 of the norm (the gather's backward
# without its all-reduce), 1.59 and more (keeping the next rank's rows)
# and 24.6 (BN's all-reduce without the one in its backward).
GRAD_NORM_RTOL = 0.1
GRAD_ELEM_RTOL = 0.5


def grad_gaps(want: Dict[str, torch.Tensor], got: Dict[str, torch.Tensor]
              ) -> Tuple[Tuple[float, str], Tuple[float, str]]:
    """The largest gaps between two sets of gradients by name: (|diff|'s
    norm / the tensor's norm, name) and (max |diff| / max |g|, name). A
    zero gradient must stay zero."""
    norm, elem = (0.0, ''), (0.0, '')
    for k, g in want.items():
        g = g.double()
        d = got[k].double() - g
        norm = max(norm, ((d.norm() / g.norm().clamp_min(1e-30)).item(), k))
        elem = max(elem, ((d.abs().max() / g.abs().max().clamp_min(1e-30)
                           ).item(), k))
    return norm, elem


def assert_same_grads(want: Dict[str, torch.Tensor],
                      got: Dict[str, torch.Tensor], label: str = '') -> None:
    """Every gradient tensor within GRAD_NORM_RTOL of its norm and,
    element by element, within GRAD_ELEM_RTOL of its largest |element|."""
    assert set(got) == set(want), (label, set(got) ^ set(want))
    (norm, kn), (elem, ke) = grad_gaps(want, got)
    assert norm <= GRAD_NORM_RTOL, f'{label}: gradient {kn} off by ' \
        f'{norm:.3g} of its norm (limit {GRAD_NORM_RTOL})'
    assert elem <= GRAD_ELEM_RTOL, f'{label}: gradient {ke} off by ' \
        f'{elem:.3g} of its largest element (limit {GRAD_ELEM_RTOL})'


def assert_same_step(want: Dict[str, Any], got: Dict[str, Any],
                     label: str = '',
                     metric_rtol: Optional[Dict[str, float]] = None
                     ) -> None:
    """A mesh step against one device's, as `step_record`s: metrics rtol
    2e-4 (or `metric_rtol[k]`) / atol 1e-6, parameters rtol 1e-4 / atol
    5e-5 and the EDL state rtol 2e-4 (the tolerances of the JAX
    package's `tests/test_mesh_train.py`), and each gradient by
    `assert_same_grads`. Adam's first step moves every weight by about
    the learning rate whatever its gradient, so the parameters alone
    would pass a wrong gradient; the gradients are held themselves."""
    for i, (a, b) in enumerate(zip(want['metrics'], got['metrics'])):
        for k in a:
            rtol = (metric_rtol or {}).get(k, 2e-4)
            np.testing.assert_allclose(b[k], a[k], rtol=rtol, atol=1e-6,
                                       err_msg=f'{label} step {i} {k}')
    assert_same_grads(want['grads'], got['grads'], label)
    for k, a in want['params'].items():
        np.testing.assert_allclose(got['params'][k].numpy(), a.numpy(),
                                   rtol=1e-4, atol=5e-5,
                                   err_msg=f'{label} {k}')
    if want['edl'] is not None:
        for k, a in want['edl'].items():
            np.testing.assert_allclose(got['edl'][k].numpy(), a.numpy(),
                                       rtol=2e-4, err_msg=f'{label} {k}')


def bitwise_diffs(want: Dict[str, Any], got: Dict[str, Any]) -> List[str]:
    """The entries of two `step_record`s that are not bit for bit
    equal."""
    bad = [k for k, v in want['metrics'][0].items()
           if v != got['metrics'][0][k]]
    for part in ('grads', 'params', 'buffers', 'edl'):
        bad += [f'{part} {k}' for k, v in (want[part] or {}).items()
                if not torch.equal(v, got[part][k])]
    return bad


def assert_world_one_step(want: Dict[str, Any], again: Dict[str, Any],
                          got: Dict[str, Any], label: str = '') -> None:
    """A step at world size 1 under DDP (`got`) against two plain steps
    from the same state (`want`, `again`), as `step_record`s. Bit for
    bit where the plain step reproduces itself. On the card it does not
    (TF32 off and cuDNN deterministic, a second plain step's gradients
    still differ, by up to ~3e-5 of a tensor's max), so there: the loss
    terms, cost, buffers (BN statistics) and EDL state, which the
    forward gives, bit for bit; each gradient within max(4 x the plain
    steps' gap, 1e-5) of its tensor's max; the grad norm at rtol max(1e-5,
    4 x the plain steps' relative gap); the parameters at the mesh
    tolerance (rtol 1e-4 / atol 5e-5)."""
    bad = bitwise_diffs(want, got)
    if not bitwise_diffs(want, again):
        assert not bad, f'{label}: DDP != a plain step that reproduces ' \
            f'itself: {bad[:8]}'
        return
    exact = [k for k in bad if not k.startswith(('grads ', 'params '))
             and k != 'grad_norm']
    assert not exact, f'{label}: {exact[:8]}'
    gap, plain_gap = (grad_gaps(want['grads'], r['grads'])[1][0]
                      for r in (got, again))
    assert gap <= max(4 * plain_gap, 1e-5), (label, gap, plain_gap)
    gn = [r['metrics'][0]['grad_norm'] for r in (want, again, got)]
    np.testing.assert_allclose(gn[2], gn[0], rtol=max(
        1e-5, 4 * abs(gn[1] - gn[0]) / gn[0]), err_msg=label)
    for k, v in want['params'].items():
        np.testing.assert_allclose(got['params'][k].numpy(), v.numpy(),
                                   rtol=1e-4, atol=5e-5,
                                   err_msg=f'{label} {k}')


def assert_same_proposals(want: Dict[str, List[Dict[str, Any]]],
                          got: Dict[str, List[Dict[str, Any]]],
                          label: str = '') -> int:
    """Per video, equal counts and, per pair (`pair_proposals`), equal
    classes, scores at rtol 1e-4 / atol 1e-6 and segments at rtol 1e-4 /
    atol 1e-4. Returns the number of proposals."""
    from opental_torch.utils.propmatch import pair_proposals
    assert set(want) == set(got), (label, sorted(want), sorted(got))
    n = 0
    for name in want:
        for a, b in pair_proposals(want[name], got[name]):
            assert a['cls'] == b['cls'], (label, name, a, b)
            np.testing.assert_allclose(b['score'], a['score'], rtol=1e-4,
                                       atol=1e-6,
                                       err_msg=f'{label} {name}')
            np.testing.assert_allclose(b['segment'], a['segment'],
                                       rtol=1e-4, atol=1e-4,
                                       err_msg=f'{label} {name}')
        n += len(got[name])
    return n


# --------------------------------------------------------------- dryrun

FRAME, CROP = 128, 32


def dryrun_multichip(n: int, device: str = 'cpu') -> Dict[str, Any]:
    """The JAX package's `dryrun_multichip(n)` on n ranks of this
    package: each leg held against one device. Returns the counts it
    checked."""
    from opental_torch import factory
    from opental_torch.infer.pipeline import InferencePipeline
    from opental_torch.losses.edl import EDLConfig, EDLState
    from opental_torch.losses.multisegment import LossConfig
    from opental_torch.models.bdnet import BDNet
    from opental_torch.train.step import (LossWeights, TrainState,
                                          make_optimizer, train_step)
    from opental_torch.utils.synthetic import tiny_train_batch

    single = 'cpu' if device == 'cpu' else 'cuda:0'     # one device
    # on the card TF32 off and cuDNN deterministic, in this process and
    # in the ranks: the checks hold float32 rounding, not TF32's
    pre: List[Job] = []
    if device != 'cpu':
        pre = [('backends', {'exact': True})]
        _job_backends(None, pre[0][1])
    # remat: the large-batch train config; the PU actionness loss
    # (act_weight 0.1) takes a max over the global batch
    model = factory.init_train_weights(BDNet(
        num_classes=16, os_head=True, use_edl=True, frame_num=FRAME,
        crop_size=CROP, remat=True), seed=0)
    edl = EDLConfig(num_classes=15, loss_type='log', evidence='exp',
                    iou_aware=True, with_ibm=True, ibm_start=10)
    loss_cfg = LossConfig(num_classes=15, clip_length=FRAME, piou=0.5,
                          cls_type='edl', edl=edl, os_head=True,
                          act_weight=0.1)
    batch = tiny_train_batch(2 * n, FRAME, CROP)
    spec = dict(model=model, loss_cfg=loss_cfg, weights=LossWeights(),
                batch=batch, epochs=[11], wd=1e-3)

    ranks = Ranks(n, pre + [('train', spec)], device)
    ref_model = copy.deepcopy(model).to(single)
    state = TrainState(model=ref_model,
                       optimizer=make_optimizer(ref_model, LR, 1e-3),
                       edl_state=EDLState.create(edl, single))
    want = step_record(state, train_step(
        state, loss_cfg, LossWeights(),
        {k: torch.from_numpy(v).to(single) for k, v in batch.items()}, 11))
    got = [r[len(pre):] for r in ranks.results()]
    for r in range(n):
        assert_same_step(want, got[r][0], f'rank {r}')
    cost = got[0][0]['metrics'][0]['cost']
    assert np.isfinite(cost), cost
    (norm, _), (elem, _) = grad_gaps(want['grads'], got[0][0]['grads'])
    print(f'dryrun_multichip({n}): cost={cost:.4f} '
          f'grad_norm={got[0][0]["metrics"][0]["grad_norm"]:.4f} '
          f'== one device (gradients within {norm:.3g} of a tensor\'s '
          f'norm, {elem:.3g} of its largest element)')

    # mesh inference: 8, 10 (> max_batch: two forwards) and 4 windows
    # (a padded tail forward); capacity 6 clips: one video per flush
    infer_model = factory.init_weights(BDNet(
        num_classes=16, os_head=True, use_edl=True, frame_num=FRAME,
        crop_size=CROP), seed=1)
    flow_model = factory.init_weights(BDNet(
        num_classes=16, os_head=True, use_edl=True, frame_num=FRAME,
        crop_size=CROP, in_channels=2), seed=2)
    pipe_kw = dict(clip_length=FRAME, stride=FRAME // 2, crop_size=CROP,
                   conf_thresh=0.01, top_k=50, nms_sigma=0.5, use_edl=True,
                   os_head=True)
    rng = np.random.RandomState(0)
    lengths = (4 * FRAME + FRAME // 2, 5 * FRAME + FRAME // 2,
               2 * FRAME + FRAME // 2)
    videos = [(f'v{i}', rng.randint(0, 255, (t, CROP + 8, CROP + 8, 3),
                                    np.uint8), t, 10.0)
              for i, t in enumerate(lengths)]
    fusion_videos = [v + (rng.randint(0, 255, (v[2] - 1, CROP + 8, CROP + 8,
                                               2), np.uint8),)
                     for v in videos[:2]]
    packed = dict(max_batch=n, frames_capacity=6 * FRAME)
    jobs = [('infer', dict(model=infer_model, pipe=pipe_kw,
                           method='run_videos', videos=videos,
                           kwargs=packed)),
            ('infer', dict(model=infer_model, flow=flow_model, pipe=pipe_kw,
                           method='run_videos', videos=fusion_videos,
                           kwargs=packed))]
    ranks = Ranks(n, pre + jobs, device)
    one = InferencePipeline(infer_model, device=single, **pipe_kw)
    want = {v[0]: one.run_video(v[1], v[2], v[3]) for v in videos}
    one_fu = InferencePipeline(infer_model, flow_model=flow_model,
                               device=single, **pipe_kw)
    want_fu = {v[0]: one_fu.run_video(v[1], v[2], v[3], flow_data=v[4])
               for v in fusion_videos}
    got = [r[len(pre):] for r in ranks.results()]
    n_props = n_fused = 0
    for r in range(n):
        n_props = assert_same_proposals(want, got[r][0]['results'],
                                        f'rank {r}')
        n_fused = assert_same_proposals(want_fu, got[r][1]['results'],
                                        f'rank {r} fused')
    print(f'dryrun_multichip({n}): mesh inference ok ({n_props} proposals '
          f'match one device; 3 flushes, 10 windows in a video against '
          f'max_batch={n}); fused ({n_fused}; flow one frame short)')
    return {'cost': cost, 'proposals': n_props, 'fused': n_fused}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('n', type=int, nargs='?', default=2)
    parser.add_argument('--device', default='cuda',
                        help='cuda (default) or cpu')
    args = parser.parse_args(argv)
    if args.device != 'cpu' and not torch.cuda.is_available():
        raise RuntimeError('no CUDA device is available; pass --device cpu')
    dryrun_multichip(args.n, args.device)


if __name__ == '__main__':
    main()
