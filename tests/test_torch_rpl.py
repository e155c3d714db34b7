"""The port's RPL / GCPL baselines vs the JAX package's, on the CPU.

`configs/thumos14_open_rpl.yaml` and `configs/thumos14_open_gcpl.yaml`
build reciprocal-point class heads (`RPLHead`) in both pyramid stages,
a learnable radius on the pyramid, and train with the RPL or GCPL loss;
GCPL decodes negated distances. Held here:
  * `RPLHead` against the flax head on the same centers (atol 1e-5);
  * `rpl_loss` and the RPL branch of the detection loss, values and
    torch.autograd gradients against jax.grad at rtol 3e-4;
  * 3 RPL and 3 GCPL train steps (frame 128, crop 32, weights carried
    across with `from_jax_variables`): costs at rtol 1e-4, loss terms at
    rtol 3e-4, the radius and every parameter after the steps;
  * the GCPL detection JSON of `tools.test.run_test` against JAX's, per
    proposal with equal evaluator metrics;
  * the factory builds both configs (`model.transformer` still raises).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from proposal_matching import assert_proposal_parity
from test_torch_train_step import make_batch, numpy_variables

from opental_tpu.config import load_config as jax_load_config
from opental_tpu.eval.detection import DetectionEvaluator
from opental_tpu.losses import cls as jcls
from opental_tpu.losses import multisegment as jms
from opental_tpu.models.bdnet import BDNet as JBDNet
from opental_tpu.models.layers import RPLHead as JRPLHead
from opental_tpu.models.pyramid import make_priors
from opental_tpu.tools import test as jax_test
from opental_tpu.train.step import (LossWeights as JLossWeights,
                                    TrainState as JTrainState,
                                    make_optimizer as jmake_optimizer,
                                    make_train_step)
from opental_tpu.utils.synthetic import make_synthetic_dataset
from opental_tpu.utils.torch_convert import (align_bn_collections,
                                             convert_bdnet_checkpoint,
                                             merge_variables)

from opental_torch import factory
from opental_torch.config import load_config
from opental_torch.losses import cls as tcls
from opental_torch.losses import multisegment as tms
from opental_torch.models.bdnet import BDNet
from opental_torch.models.layers import RPLHead
from opental_torch.tools import test as port_test
from opental_torch.train.step import (LossWeights, TrainState,
                                      make_optimizer, train_step)
from opental_torch.utils.convert import from_jax_variables

FRAME, CROP = 128, 32
RTOL, ATOL = 3e-4, 1e-6
RPL = {'model.use_edl': False, 'model.os_head': False,
       'model.use_rpl': True, 'training.edl_loss': False,
       'training.rpl_loss': True}
GCPL_CFG = {'gcpl': True, 'temperature': 1, 'weight_pl': 0.1}


@pytest.fixture(scope='module', autouse=True)
def few_threads():
    """Two torch threads per pytest worker: the workers share the
    host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def test_rpl_head_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 9, 64).astype(np.float32)
    for num_centers in (1, 3):
        jh = JRPLHead(5, num_centers=num_centers)
        v = jh.init(jax.random.PRNGKey(num_centers), jnp.asarray(x))
        want = np.asarray(jh.apply(v, jnp.asarray(x)))
        th = RPLHead(5, 64, num_centers=num_centers)
        with torch.no_grad():
            th.centers.copy_(torch.from_numpy(np.asarray(
                v['params']['centers'])))
            got = th(torch.from_numpy(x)).numpy()
        assert got.shape == (2, 9, 5)
        np.testing.assert_allclose(got, want, atol=1e-5)


def _grad_both(jfn, tfn, arrays):
    jv, jg = jax.value_and_grad(jfn, argnums=tuple(range(len(arrays))))(
        *[jnp.asarray(a) for a in arrays])
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    tv = tfn(*ts)
    tg = torch.autograd.grad(tv, ts, allow_unused=True)
    return (float(jv), [np.asarray(g) for g in jg], float(tv.detach()),
            [np.zeros_like(a) if g is None else g.numpy()
             for g, a in zip(tg, arrays)])


def _assert_same(jv, jg, tv, tg, what=''):
    np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=ATOL,
                               err_msg=f'{what} value')
    for i, (a, b) in enumerate(zip(tg, jg)):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                   err_msg=f'{what} grad {i}')


@pytest.mark.parametrize('mean', [False, True])
@pytest.mark.parametrize('gcpl', [False, True])
def test_rpl_loss(gcpl, mean):
    rng = np.random.RandomState(int(gcpl) * 2 + int(mean))
    n, k, d = 50, 6, 16
    dist = np.abs(rng.randn(n, k)).astype(np.float32) * 2
    feats = rng.randn(n, d).astype(np.float32)
    centers = (0.3 * rng.randn(k, d)).astype(np.float32)
    radius = np.float32(0.4)
    target = rng.randint(0, k, n)
    valid = rng.rand(n) > 0.3
    kw = dict(temperature=0.7, weight_pl=0.1, gcpl=gcpl,
              reduction_mean=mean)

    def jf(ds, f, c, r):
        return jcls.rpl_loss(ds, jnp.asarray(target), jnp.asarray(valid),
                             f, c, r, **kw)

    def tf(ds, f, c, r):
        return tcls.rpl_loss(ds, torch.from_numpy(target),
                             torch.from_numpy(valid), f, c, r, **kw)

    _assert_same(*_grad_both(jf, tf, [dist, feats, centers, radius]))


def loss_inputs(seed, b=2, d=32, k=16):
    """A random out_dict of an RPL model at frame 128 (63 priors) and a
    matching target batch."""
    rng = np.random.RandomState(seed)
    p = make_priors(FRAME).shape[0]
    arrays = {
        'loc': rng.uniform(1.0, 30.0, (b, p, 2)),
        'conf': np.abs(rng.randn(b, p, k)) * 2,
        'prop_loc': rng.randn(b, p, 2) * 0.3,
        'prop_conf': np.abs(rng.randn(b, p, k)) * 2,
        'center': rng.randn(b, p, 1),
        'ctr_feat': rng.randn(b, p, d),
        'prop_ctr_feat': rng.randn(b, p, d),
        'cls_ctr': 0.3 * rng.randn(k, d),
        'prop_cls_ctr': 0.3 * rng.randn(k, d),
        'rpl_radius': np.array([0.25]),
    }
    batch = make_batch(seed, batch_size=b)
    return ({n_: a.astype(np.float32) for n_, a in arrays.items()},
            batch['truths'], batch['labels'], batch['gt_mask'])


@pytest.mark.parametrize('term', ['loss_c', 'loss_prop_c', 'total'])
@pytest.mark.parametrize('gcpl', [False, True])
def test_multisegment_rpl_terms(gcpl, term):
    """The RPL branch of the detection loss (the refined stage takes the
    mean), each classification term and the sum of all terms, against
    jax.grad through every float input."""
    arrays, truths, labels, gt_mask = loss_inputs(3 + int(gcpl))
    names = list(arrays)
    priors = make_priors(FRAME)
    kw = dict(num_classes=16, clip_length=FRAME, piou=0.5, cls_type='rpl',
              rpl_gcpl=gcpl, rpl_temperature=1.0, rpl_weight_pl=0.1)
    jcfg, tcfg = jms.LossConfig(**kw), tms.LossConfig(**kw)

    def pick(losses):
        return sum(losses.values()) if term == 'total' else losses[term]

    def jf(*xs):
        out = dict(zip(names, xs), priors=jnp.asarray(priors), act=None,
                   prop_act=None)
        losses, _ = jms.multisegment_loss(
            jcfg, out, jnp.asarray(truths), jnp.asarray(labels),
            jnp.asarray(gt_mask))
        return pick(losses)

    def tf(*xs):
        out = dict(zip(names, xs), priors=torch.from_numpy(priors),
                   act=None, prop_act=None)
        losses, _ = tms.multisegment_loss(
            tcfg, out, torch.from_numpy(truths), torch.from_numpy(labels),
            torch.from_numpy(gt_mask))
        return pick(losses)

    _assert_same(*_grad_both(jf, tf, [arrays[n_] for n_ in names]),
                 what=term)


# ------------------------------------------------------------ 3 steps

LR, WD = 1e-5, 1e-3
EPOCHS = (1, 2, 3)
TERMS = ('loss_l', 'loss_c', 'loss_prop_l', 'loss_prop_c', 'loss_ct',
         'loss_start', 'loss_end', 'loss_trip')


@pytest.fixture(scope='module', params=[False, True],
                ids=['rpl', 'gcpl'])
def three_steps(request):
    """3 RPL (or GCPL) steps in each package from the same variables
    (the flax init's shapes with numpy values, the radius off 0)."""
    jm = JBDNet(num_classes=16, use_rpl=True, frame_num=FRAME,
                deterministic=False)
    x0 = jnp.zeros((1, FRAME, CROP, CROP, 3), jnp.float32)
    v = numpy_variables(dict(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                            x0)), seed=2)
    kw = dict(num_classes=16, clip_length=FRAME, piou=0.5, cls_type='rpl',
              rpl_temperature=1.0, rpl_weight_pl=0.1,
              rpl_gcpl=request.param)
    tx = jmake_optimizer(LR, WD)
    jstate = JTrainState(params=v['params'], constants=v['constants'],
                         opt_state=tx.init(v['params']), edl_state=None)
    jstep = jax.jit(make_train_step(jm, jms.LossConfig(**kw),
                                    JLossWeights(), tx))
    tm = BDNet(num_classes=16, use_rpl=True, frame_num=FRAME,
               crop_size=CROP)
    tm.load_state_dict(from_jax_variables(v), strict=True)
    tstate = TrainState(model=tm, optimizer=make_optimizer(tm, LR, WD))
    tcfg = tms.LossConfig(**kw)
    radius0 = float(np.asarray(v['params']['pyramid']['rpl_radius'])[0])
    rows = []
    for i, epoch in enumerate(EPOCHS):
        batch = make_batch(seed=20 + i)
        jstate, jmet = jstep(jstate, {k: jnp.asarray(a)
                                      for k, a in batch.items()},
                             jnp.asarray(epoch))
        tmet = train_step(tstate, tcfg, LossWeights(),
                          {k: torch.from_numpy(a) for k, a in batch.items()},
                          epoch)
        rows.append(({k: float(a) for k, a in jmet.items()},
                     {k: float(a) for k, a in tmet.items()}))
    return jstate, tstate, rows, radius0


@pytest.mark.parametrize('i', range(len(EPOCHS)))
def test_rpl_step_costs_and_terms(three_steps, i):
    _, _, rows, _ = three_steps
    jm, tm = rows[i]
    np.testing.assert_allclose(tm['cost'], jm['cost'], rtol=1e-4,
                               err_msg=f'step {i} cost')
    for term in TERMS:
        np.testing.assert_allclose(tm[term], jm[term], rtol=RTOL,
                                   atol=1e-7, err_msg=f'step {i} {term}')
    assert tm['loss_c'] > 0 and tm['loss_prop_c'] > 0
    np.testing.assert_allclose(tm['grad_norm'], jm['grad_norm'], rtol=1e-3)


def test_rpl_radius_and_parameters_after_steps(three_steps):
    jstate, tstate, _, radius0 = three_steps
    want = from_jax_variables({'params': jax.tree_util.tree_map(
        np.asarray, jstate.params)})
    got = dict(tstate.model.named_parameters())
    assert set(want) == set(got)
    key = 'coarse_pyramid_detection.rpl_radius'
    radius = got[key].detach()
    torch.testing.assert_close(radius, want[key], rtol=1e-4, atol=5e-6)
    # the radius moves: by its loss (RPL) or by weight decay (GCPL)
    assert float(radius[0]) != radius0
    for name in ('conf_head', 'prop_conf_head'):
        c = f'coarse_pyramid_detection.{name}.centers'
        assert got[c].shape == (16, 512)
    for k, w in want.items():
        torch.testing.assert_close(got[k].detach(), w, rtol=1e-4,
                                   atol=5e-5, msg=lambda m: f'{k}: {m}')


# ------------------------------------------------------- configs / CLI


def test_factory_builds_the_baseline_configs():
    for name, gcpl in (('thumos14_open_rpl', False),
                       ('thumos14_open_gcpl', True)):
        cfg = load_config(f'configs/{name}.yaml')
        model = factory.build_model(cfg, frame_num=FRAME, crop_size=CROP)
        assert model.use_rpl and not model.use_edl
        sd = factory.init_train_weights(model, seed=0).state_dict()
        assert float(sd['coarse_pyramid_detection.rpl_radius']) == 0.0
        std = float(sd['coarse_pyramid_detection.conf_head.centers'].std())
        assert 0.08 < std < 0.12
        lcfg = factory.build_loss_config(cfg)
        assert (lcfg.cls_type, lcfg.rpl_gcpl) == ('rpl', gcpl)
        assert (lcfg.rpl_temperature, lcfg.rpl_weight_pl) == (1, 0.1)
    cfg = load_config('configs/thumos14_open_rpl.yaml',
                      overrides={'model.transformer': True})
    with pytest.raises(NotImplementedError, match='transformer'):
        factory.build_model(cfg)


def jax_variables(model, checkpoint_path, sample_shape):
    """JAX's `tools.test.load_variables` on a `jax.eval_shape` template
    (no compiled init); the RPL radius, which JAX's key map leaves out,
    comes from the file."""
    template = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                              jnp.zeros(sample_shape, jnp.float32))
    loaded = align_bn_collections(convert_bdnet_checkpoint(checkpoint_path),
                                  template['params'])
    sd = torch.load(checkpoint_path, weights_only=True)
    loaded['params']['pyramid']['rpl_radius'] = \
        sd['coarse_pyramid_detection.rpl_radius'].numpy()
    return {k: merge_variables(template[k], loaded[k], strict=True)
            for k in ('params', 'constants')}


@pytest.fixture(scope='module')
def gcpl_runs(tmp_path_factory):
    """The GCPL config on a synthetic dataset with seeded port weights:
    (root, JAX's JSON, the port's JSON)."""
    root = str(tmp_path_factory.mktemp('gcpl') / 'synth')
    cfg_path = make_synthetic_dataset(root, n_train=1, n_test=3,
                                      clip_length=FRAME, crop_size=CROP,
                                      temporal_ramp=True)
    overrides = dict(RPL, **{'training.rpl_config': GCPL_CFG,
                             'model.compute_dtype': 'float32',
                             'testing.packed_batch': 4,
                             'testing.packed_frames': 512})
    model = factory.init_weights(factory.build_model(
        load_config(cfg_path, overrides=overrides), frame_num=FRAME,
        crop_size=CROP), seed=3)
    ckpt = os.path.join(root, 'gcpl.ckpt')
    torch.save(model.state_dict(), ckpt)
    overrides['testing.checkpoint_path'] = ckpt
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_test, 'load_variables', jax_variables)
        jax_path = jax_test.run_test(jax_load_config(cfg_path, overrides=dict(
            overrides, **{'testing.output_json': 'jax.json'})))
    port_path = port_test.run_test(load_config(cfg_path, overrides=dict(
        overrides, **{'testing.output_json': 'port.json'})), device='cpu')
    return root, jax_path, port_path


def test_gcpl_json_matches_jax(gcpl_runs):
    _, jax_path, port_path = gcpl_runs
    with open(jax_path) as f:
        want = json.load(f)
    with open(port_path) as f:
        got = json.load(f)
    assert_proposal_parity(want, got, min_total=50)


def test_gcpl_metrics_equal_jax(gcpl_runs):
    root, jax_path, port_path = gcpl_runs
    anno = os.path.join(root, 'annotations')

    def metrics(pred):
        ev = DetectionEvaluator(
            os.path.join(anno, 'gt_open.json'), pred,
            os.path.join(anno, 'Class_Index_Known.txt'),
            tiou_thresholds=np.array([0.3, 0.5, 0.7]), subset=['test'],
            openset=True)
        m, _, _ = ev.evaluate('AP')
        ev.pre_evaluate()
        return np.concatenate([np.atleast_1d(np.asarray(x, np.float64))
                               for x in (m, *ev.evaluate('AUC'),
                                         ev.evaluate('OSDR'))])

    np.testing.assert_allclose(metrics(port_path), metrics(jax_path),
                               atol=1e-6)


def test_gcpl_scores_are_negated_distances(gcpl_runs):
    """The CLI builds the pipeline with use_gcpl exactly for a GCPL
    config with RPL heads."""
    root, _, _ = gcpl_runs
    cfg_path = os.path.join(root, 'config.yaml')
    ckpt = os.path.join(root, 'gcpl.ckpt')
    for rpl_cfg, want in ((GCPL_CFG, True), ({'gcpl': False}, False)):
        pipe, _, _ = port_test.build_pipeline(load_config(
            cfg_path, overrides=dict(RPL, **{
                'training.rpl_config': rpl_cfg,
                'testing.checkpoint_path': ckpt})), device='cpu')
        assert pipe.use_gcpl is want
