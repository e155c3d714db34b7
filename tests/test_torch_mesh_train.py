"""The port's data-parallel train step vs the JAX package's mesh step.

Two gloo ranks on the CPU (`opental_torch.parallel.dryrun.Ranks`: spawned
processes, a `file://` rendezvous under tmp_path, one thread each) take
one OpenTAL-final step past the MIB gate (epoch 11, ibm_start 10) with
the PU actionness loss on (act_weight 0.1) on a global batch of 4, two
rows each; the JAX package takes the same step on `make_mesh(2)` of the
conftest's 8 CPU devices, from the same flax variables (carried over
with `from_jax_variables`). Held, as `tests/test_mesh_train.py` holds
the JAX mesh against one device: metrics rtol 2e-4 / atol 1e-6,
parameters rtol 1e-4 / atol 5e-5, the EDL state rtol 2e-4; each
gradient tensor as `parallel.dryrun.assert_same_grads` holds it (JAX's
gradients kept by a pass-through ahead of its optimizer); both ranks
end equal. The loss is the global batch's: the per-rank losses differ
from it. Also: a mesh of one equals the plain step bit for bit, the
mesh helpers' guards, and `--use_mesh` training through the CLI.
`test_torch_mesh_train_bn.py` takes the `freeze_bn: false` step and
`test_torch_mesh_anet.py` an ANet step the same way.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from opental_tpu.losses.edl import EDLConfig as JEDLConfig
from opental_tpu.losses.edl import EDLState as JEDLState
from opental_tpu.losses.multisegment import LossConfig as JLossConfig
from opental_tpu.models.bdnet import BDNet as JBDNet
from opental_tpu.parallel import mesh as jmesh
from opental_tpu.train.step import (LossWeights as JLossWeights,
                                    TrainState as JTrainState,
                                    make_optimizer as jmake_optimizer,
                                    make_train_step)

from opental_torch.config import (build_arg_parser, config_from_namespace,
                                   load_config)
from opental_torch.losses.edl import EDLConfig, EDLState
from opental_torch.losses.multisegment import LossConfig
from opental_torch.models.bdnet import BDNet
from opental_torch.parallel import mesh as meshlib
from opental_torch.parallel.dryrun import (LR, Ranks, assert_same_grads,
                                           grad_gaps)
from opental_torch.train.step import (LossWeights, TrainState,
                                      compute_losses, device_ingest,
                                      make_optimizer, train_step)
from opental_torch.utils.convert import from_jax_variables
from opental_torch.utils.synthetic import make_synthetic_dataset

from test_torch_train_step import EDL, TERMS, numpy_variables
from torch_suite import suite_policy  # noqa: F401 (autouse)

FRAME, CROP = 128, 32
WD = 1e-3
WORLD, BATCH, EPOCH = 2, 4, 11
LOSS = dict(num_classes=15, clip_length=FRAME, piou=0.5, cls_type='edl',
            os_head=True, act_margin=1.0, act_weight=0.1)


def mesh_batch(seed: int = 30, batch_size: int = BATCH):
    """A numpy batch whose rows differ in every target (GT count and
    place, heatmaps, SSL flags), so that a per-rank loss differs from
    the global one."""
    rng = np.random.RandomState(seed)
    n_max = 4
    truths = np.zeros((batch_size, n_max, 2), np.float32)
    labels = np.zeros((batch_size, n_max), np.int32)
    gt_mask = np.zeros((batch_size, n_max), bool)
    for b in range(batch_size):
        k = 1 + b % (n_max - 1)
        s = rng.uniform(0, 0.7, k)
        truths[b, :k, 0] = s
        truths[b, :k, 1] = np.clip(s + rng.uniform(0.05, 0.3, k), 0, 1)
        labels[b, :k] = rng.randint(1, 16, k)
        gt_mask[b, :k] = True
    return {
        'clips': rng.uniform(-1, 1, (batch_size, FRAME, CROP, CROP, 3)
                             ).astype(np.float32),
        'truths': truths, 'labels': labels, 'gt_mask': gt_mask,
        'scores': (rng.rand(batch_size, 2, FRAME) > 0.9).astype(np.float32),
        'ssl_clips': rng.uniform(-1, 1, (batch_size, FRAME, CROP, CROP, 3)
                                 ).astype(np.float32),
        'ssl_props': np.tile(np.array([[[10., 40.], [60., 100.],
                                        [45., 55.]]], np.float32),
                             (batch_size, 1, 1)),
        'ssl_flags': np.array([1.0, 0.0, 1.0, 1.0][:batch_size],
                              np.float32),
    }


def port_model(v, freeze_bn: bool = True) -> BDNet:
    tm = BDNet(num_classes=16, os_head=True, use_edl=True, frame_num=FRAME,
               crop_size=CROP, freeze_bn=freeze_bn)
    tm.load_state_dict(from_jax_variables(v), strict=True)
    return tm


def port_loss() -> LossConfig:
    return LossConfig(edl=EDLConfig(**EDL), **LOSS)


def jax_variables(freeze_bn: bool = True):
    jm = JBDNet(num_classes=16, os_head=True, use_edl=True, frame_num=FRAME,
                deterministic=False, freeze_bn=freeze_bn)
    x0 = jnp.zeros((1, FRAME, CROP, CROP, 3), jnp.float32)
    return jm, numpy_variables(dict(jax.eval_shape(
        jm.init, jax.random.PRNGKey(0), x0)))


def keeping_grads(tx):
    """`tx` after a pass-through whose state keeps the step's gradients
    (`opt_state[0]` after the step)."""
    return optax.chain(optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates)), tx)


def port_grads(grads) -> dict:
    """A flax gradient tree under the port's parameter names."""
    return from_jax_variables({'params': jax.tree_util.tree_map(
        np.asarray, grads)})


def jax_mesh_step(jm, v, batch, epoch=EPOCH):
    """The JAX package's step on make_mesh(WORLD): the state replicated,
    the batch sharded; returns (metrics, params and constants as the
    port's state_dict, EDL state, gradients by the port's names)."""
    jcfg = JLossConfig(edl=JEDLConfig(**EDL), **LOSS)
    tx = keeping_grads(jmake_optimizer(LR, WD))
    state = JTrainState(params=v['params'], constants=v['constants'],
                        opt_state=tx.init(v['params']),
                        edl_state=JEDLState.create(jcfg.edl))
    mesh = jmesh.make_mesh(WORLD)
    step = jax.jit(make_train_step(jm, jcfg, JLossWeights(), tx))
    state, metrics = step(jmesh.replicate(mesh, state),
                          jmesh.shard_batch(mesh, {
                              k: jnp.asarray(x) for k, x in batch.items()}),
                          jnp.asarray(epoch))
    sd = from_jax_variables(jax.tree_util.tree_map(
        np.asarray, {'params': state.params,
                     'constants': state.constants}))
    return ({k: float(x) for k, x in metrics.items()}, sd,
            {k: torch.from_numpy(np.asarray(x)) for k, x in
             state.edl_state._asdict().items()},
            port_grads(state.opt_state[0]))


def train_job(model, batch, epochs=(EPOCH,)):
    return ('train', dict(model=model, loss_cfg=port_loss(),
                          weights=LossWeights(), batch=batch,
                          epochs=list(epochs), wd=WD))


@pytest.fixture(scope='module')
def steps(tmp_path_factory):
    """(JAX mesh step, the two ranks' results): the ranks run while JAX
    compiles."""
    jm, v = jax_variables()
    batch = mesh_batch()
    ranks = Ranks(WORLD, [train_job(port_model(v), batch)],
                  root=str(tmp_path_factory.mktemp('mesh_train')))
    want = jax_mesh_step(jm, v, batch)
    return want, [r[0] for r in ranks.results()], v, batch


def test_metrics_match_jax_mesh(steps):
    (jm, _, _, _), got, _, _ = steps
    for rank, res in enumerate(got):
        tm = res['metrics'][0]
        for k in TERMS + ('cost', 'grad_norm'):
            np.testing.assert_allclose(tm[k], jm[k], rtol=2e-4, atol=1e-6,
                                       err_msg=f'rank {rank} {k}')
    assert got[0]['metrics'][0]['loss_trip'] > 0
    assert got[0]['metrics'][0]['loss_act'] > 0


def test_parameters_match_jax_mesh(steps):
    (_, sd, _, _), got, _, _ = steps
    for rank, res in enumerate(got):
        for k, p in res['params'].items():
            torch.testing.assert_close(p, sd[k], rtol=1e-4, atol=5e-5,
                                       msg=lambda m: f'rank {rank} {k}: {m}')


def test_gradients_match_jax_mesh(steps, record_property):
    """Each rank's gradients after DDP's reduction against JAX's
    (`assert_same_grads`; the largest gaps go to the junit XML as
    `grad_gaps`): the parameters' check cannot see a wrong gradient, as
    Adam's first step moves every weight by about the learning rate."""
    (_, _, _, grads), got, _, _ = steps
    record_property('grad_gaps', grad_gaps(grads, got[0]['grads']))
    for rank, res in enumerate(got):
        assert_same_grads(grads, res['grads'], f'rank {rank}')


def test_edl_state_matches_jax_mesh(steps):
    (_, _, edl, _), got, _, _ = steps
    for rank, res in enumerate(got):
        for k, x in edl.items():
            torch.testing.assert_close(res['edl'][k], x, rtol=2e-4,
                                       atol=1e-7,
                                       msg=lambda m: f'rank {rank} {k}: {m}')
    assert not torch.equal(got[0]['edl']['weight_accum'],
                           torch.ones_like(edl['weight_accum']))


def test_ranks_end_equal(steps):
    _, got, _, _ = steps
    assert got[0]['metrics'] == got[1]['metrics']
    for k, p in got[0]['params'].items():
        assert torch.equal(p, got[1]['params'][k]), k
    for k, x in got[0]['edl'].items():
        assert torch.equal(x, got[1]['edl'][k]), k


def test_loss_is_the_global_batch(steps):
    """The mesh's loss terms are the global batch's, not the mean of the
    two ranks' own terms, which differ from them (the normalizers, the
    PU max, the SSL flag mean)."""
    _, got, v, batch = steps
    torch.manual_seed(0)
    model = port_model(v).train()

    def terms(rows):
        with torch.no_grad():
            _, t, _ = compute_losses(
                model, port_loss(), LossWeights(),
                device_ingest({k: torch.from_numpy(x[rows])
                               for k, x in batch.items()}),
                EDLState.create(port_loss().edl), EPOCH)
        return {k: float(x) for k, x in t.items()}

    whole = terms(slice(0, BATCH))
    halves = [terms(slice(0, 2)), terms(slice(2, 4))]
    gaps = {}
    for k in TERMS + ('cost',):
        np.testing.assert_allclose(got[0]['metrics'][0][k], whole[k],
                                   rtol=1e-5, atol=1e-7, err_msg=k)
        mean = np.mean([h[k] for h in halves])
        gaps[k] = abs(mean - whole[k]) / max(abs(whole[k]), 1e-12)
    # up to 1.2 % here (loss_act: the PU max), 500 x the match above
    assert max(gaps.values()) > 5e-3, gaps


def test_mesh_of_one_equals_the_plain_step(tmp_path):
    """DDP and the gathers at world size 1 (gloo) change nothing: the
    step equals the plain `train_step` bit for bit (one thread on both
    sides)."""
    _, v = jax_variables()
    batch = mesh_batch(seed=31, batch_size=2)
    ranks = Ranks(1, [train_job(port_model(v), batch)], root=str(tmp_path))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        model = port_model(v)
        state = TrainState(model=model,
                           optimizer=make_optimizer(model, LR, WD),
                           edl_state=EDLState.create(port_loss().edl))
        m = train_step(state, port_loss(), LossWeights(),
                       {k: torch.from_numpy(x) for k, x in batch.items()},
                       EPOCH)
    finally:
        torch.set_num_threads(threads)
    (got,) = ranks.results()[0]
    assert got['metrics'][0] == {k: float(x) for k, x in m.items()}
    for k, p in model.named_parameters():
        assert torch.equal(got['params'][k], p.detach()), k
    for k, x in state.edl_state._asdict().items():
        assert torch.equal(got['edl'][k], x), k


def test_shard_batch_keeps_contiguous_rows():
    batch = {'a': np.arange(8).reshape(4, 2), 'b': torch.arange(4)}
    mesh = meshlib.Mesh(group=None, rank=1, size=2,
                        device=torch.device('cpu'))
    rows = meshlib.shard_batch(mesh, batch)
    np.testing.assert_array_equal(rows['a'], [[4, 5], [6, 7]])
    assert rows['b'].tolist() == [2, 3]
    with pytest.raises(ValueError, match='divide'):
        meshlib.shard_batch(mesh, {'a': np.zeros((3, 1))})


def test_make_mesh_refusals(monkeypatch):
    """A world larger than one needs an address; the card is not
    replaced by the CPU."""
    for key in ('MASTER_ADDR', 'RANK', 'WORLD_SIZE', 'LOCAL_RANK'):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(ValueError, match='address'):
        meshlib.make_mesh(world_size=2, rank=0, device='cpu')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        meshlib.make_mesh(world_size=1, device='cuda')


def test_use_mesh_reaches_train(tmp_path):
    """`tools.train <cfg> --use_mesh` trains on the mesh: both ranks
    take the same steps on their halves of each global batch, rank 0
    alone logs (and would write the checkpoints); --batch_size must
    divide over the mesh."""
    cfg_path = make_synthetic_dataset(str(tmp_path / 'synth'), n_train=4,
                                      clip_length=FRAME, crop_size=CROP)
    def config(argv):
        return config_from_namespace(build_arg_parser().parse_args(argv))

    assert config([cfg_path, '--use_mesh']).get_path(
        'training.use_mesh') is True
    assert not config([cfg_path]).get_path('training.use_mesh', False)
    argv = [cfg_path, '--use_mesh', '--device', 'cpu', '--batch_size', '2',
            '--max_epoch', '1', '--max_steps_per_epoch', '2']
    ranks = Ranks(WORLD, [('train_cli', dict(argv=argv))],
                  root=str(tmp_path))
    ranks.results()
    metrics = os.path.join(load_config(cfg_path).training['checkpoint_path'],
                           'metrics.jsonl')
    with open(metrics) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    assert [r['step'] for r in recs] == [1, 2]
    assert all(np.isfinite(r['cost']) and r['grad_norm'] > 0 for r in recs)
    bad = [cfg_path, '--use_mesh', '--device', 'cpu', '--batch_size', '3',
           '--max_epoch', '1', '--max_steps_per_epoch', '1']
    with pytest.raises(Exception, match='divide'):
        Ranks(WORLD, [('train_cli', dict(argv=bad))],
              root=str(tmp_path)).results()

