"""The port's training losses vs the JAX package's, on the CPU: values and
torch.autograd gradients against jax.grad at rtol 3e-4 (the loss-term
tolerance the JAX package met against the reference), the EDL variants
before and after their epoch gates, with the new EDLState."""

import numpy as np
import pytest
import torch

from torch_suite import suite_policy  # noqa: F401 (autouse)

import jax
import jax.numpy as jnp

from opental_tpu.losses import boundary as jbd
from opental_tpu.losses import cls as jcls
from opental_tpu.losses import edl as jedl
from opental_tpu.losses import multisegment as jms

from opental_torch.losses import boundary as tbd
from opental_torch.losses import cls as tcls
from opental_torch.losses import edl as tedl
from opental_torch.losses import multisegment as tms

RTOL = 3e-4
ATOL = 1e-6


def _grad_both(jfn, tfn, *arrays):
    """(value, grads) of a scalar function of float arrays in both
    frameworks."""
    jv, jg = jax.value_and_grad(jfn, argnums=tuple(range(len(arrays))))(
        *[jnp.asarray(a) for a in arrays])
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    tv = tfn(*ts)
    tg = torch.autograd.grad(tv, ts, allow_unused=True)
    return (float(jv), [np.asarray(g) for g in jg],
            float(tv.detach()), [np.zeros_like(a) if g is None else g.numpy()
                        for g, a in zip(tg, arrays)])


def _assert_same(jv, jg, tv, tg, what=''):
    np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=ATOL,
                               err_msg=f'{what} value')
    for i, (a, b) in enumerate(zip(tg, jg)):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                   err_msg=f'{what} grad {i}')


@pytest.mark.parametrize('size_average', [False, True])
def test_focal_loss(size_average):
    rng = np.random.RandomState(0)
    logits = rng.randn(40, 6).astype(np.float32) * 2
    target = rng.randint(0, 6, 40)
    valid = rng.rand(40) > 0.3

    def jf(lg):
        return jcls.focal_loss(jax.nn.softmax(lg, 1), jnp.asarray(target),
                               jnp.asarray(valid), 6,
                               size_average=size_average)

    def tf(lg):
        return tcls.focal_loss(torch.softmax(lg, 1),
                               torch.from_numpy(target),
                               torch.from_numpy(valid), 6,
                               size_average=size_average)

    _assert_same(*_grad_both(jf, tf, logits))


@pytest.mark.parametrize('n_pos', [0, 1, 7, 30])
def test_actionness_loss(n_pos):
    rng = np.random.RandomState(n_pos)
    logits = rng.randn(50).astype(np.float32) * 3
    labels = np.zeros(50, np.float32)
    labels[rng.permutation(50)[:n_pos]] = 1.0
    valid = np.ones(50, bool)
    valid[:3] = False
    for size_average in (False, True):
        def jf(lg):
            loss, count = jcls.actionness_loss(
                lg, jnp.asarray(labels), jnp.asarray(valid), margin=1.0,
                rank_weight=0.1, size_average=size_average)
            return loss / jnp.maximum(count, 1.0)

        def tf(lg):
            loss, count = tcls.actionness_loss(
                lg, torch.from_numpy(labels), torch.from_numpy(valid),
                margin=1.0, rank_weight=0.1, size_average=size_average)
            return loss / count.clamp_min(1.0)

        _assert_same(*_grad_both(jf, tf, logits), what=str(size_average))


EDL_VARIANTS = {
    'log': dict(),
    'digamma': dict(loss_type='digamma'),
    'mse': dict(loss_type='mse'),
    'focal': dict(with_focal=True),
    'soft_label': dict(soft_label=0.1),
    'ghm': dict(with_ghm=True, ghm_start=10),
    'ghm_no_momentum': dict(with_ghm=True, momentum=0.0, ghm_start=10),
    'ibloss': dict(with_ibloss=True, ib_start=10),
    'ibm_exp': dict(with_ibm=True, ibm_exp=True, ibm_start=10),
    'mib': dict(with_ibm=True, ibm_start=10),
    'mib_relu': dict(with_ibm=True, ibm_start=10, evidence='relu'),
    'mean': dict(size_average=True),
}


@pytest.mark.parametrize('epoch', [9, 10])
@pytest.mark.parametrize('variant', sorted(EDL_VARIANTS))
def test_evidence_loss(variant, epoch):
    kw = EDL_VARIANTS[variant]
    rng = np.random.RandomState(3)
    n, k = 60, 7
    logits = (rng.randn(n, k) * 3).astype(np.float32)
    if kw.get('evidence') == 'relu':
        # all-negative rows: zero evidence, grad norm 0, MIB bin 0, which
        # wraps to the last slot
        logits[:6] = -np.abs(logits[:6])
    target = rng.randint(0, k, n)
    valid = rng.rand(n) > 0.25
    valid[:6] = True
    jcfg = jedl.EDLConfig(num_classes=k, num_bins=20, **kw)
    tcfg = tedl.EDLConfig(num_classes=k, num_bins=20, **kw)
    accum = (1.0 + rng.rand(20)).astype(np.float32)
    acc_sum = (rng.rand(20) * 3).astype(np.float32)
    jstate = jedl.EDLState(jnp.asarray(accum), jnp.asarray(acc_sum))
    tstate = tedl.EDLState(torch.from_numpy(accum.copy()),
                           torch.from_numpy(acc_sum.copy()))
    out = {}

    def jf(lg):
        loss, st = jedl.evidence_loss(jcfg, lg, jnp.asarray(target),
                                      jnp.asarray(valid), jstate,
                                      jnp.asarray(epoch))
        out['j'] = st
        return loss

    def tf(lg):
        loss, st = tedl.evidence_loss(tcfg, lg, torch.from_numpy(target),
                                      torch.from_numpy(valid), tstate,
                                      epoch)
        out['t'] = st
        return loss

    _assert_same(*_grad_both(jf, tf, logits), what=variant)
    for name in ('weight_accum', 'acc_sum'):
        np.testing.assert_allclose(
            getattr(out['t'], name).detach().numpy(),
            np.asarray(getattr(out['j'], name)), rtol=1e-5, atol=1e-7,
            err_msg=name)
    if variant == 'mib':
        changed = not np.array_equal(out['t'].weight_accum.numpy(), accum)
        assert changed == (epoch >= 10)
    if variant == 'mib_relu':
        # bin 0 wrapped onto the last slot, which moved from epoch 10 on
        last = out['t'].weight_accum[-1].item()
        assert (last != accum[-1]) == (epoch >= 10)


def test_edl_state_create():
    cfg = tedl.EDLConfig(num_classes=5, num_bins=50)
    st = tedl.EDLState.create(cfg)
    want = jedl.EDLState.create(jedl.EDLConfig(num_classes=5, num_bins=50))
    for a, b in zip(st, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert a.dtype == torch.float32


@pytest.mark.parametrize('evidence', ['exp', 'relu'])
def test_iou_calibration(evidence):
    rng = np.random.RandomState(4)
    logits = (rng.randn(80, 9) * 2).astype(np.float32)
    ious = rng.uniform(-0.3, 1.0, 80).astype(np.float32)
    jcfg = jedl.EDLConfig(num_classes=9, evidence=evidence)
    tcfg = tedl.EDLConfig(num_classes=9, evidence=evidence)
    for mean in (True, False):
        _assert_same(*_grad_both(
            lambda lg: jedl.iou_calibration(jcfg, lg, jnp.asarray(ious),
                                            mean),
            lambda lg: tedl.iou_calibration(tcfg, lg,
                                            torch.from_numpy(ious), mean),
            logits), what=str(mean))


def test_boundary_losses():
    rng = np.random.RandomState(5)
    b, t = 2, 64
    # the model's boundary features are ReLU outputs: scores in [0, 1)
    arrays = [np.abs(rng.randn(*shape)).astype(np.float32)
              for shape in [(b, t, 16)] * 2 + [(b, t // 4, 32)] * 4]
    scores = (rng.rand(b, 2, t) > 0.8).astype(np.float32)
    keys = ('start', 'end', 'start_loc_prop', 'start_conf_prop',
            'end_loc_prop', 'end_conf_prop')

    def jf(*xs):
        s, e = jbd.boundary_losses(dict(zip(keys, xs)), jnp.asarray(scores))
        return s + 2.0 * e

    def tf(*xs):
        s, e = tbd.boundary_losses(dict(zip(keys, xs)),
                                   torch.from_numpy(scores))
        return s + 2.0 * e

    _assert_same(*_grad_both(jf, tf, *arrays))


def test_triplet_losses():
    rng = np.random.RandomState(6)
    arrays = [rng.randn(3, 24).astype(np.float32) * s
              for s in (1, 1, 1, 0.3, 0.3, 2, 1, 1, 1)]

    def jf(*xs):
        return jbd.ssl_triplet_loss(xs[0::3], xs[1::3], xs[2::3])

    def tf(*xs):
        return tbd.ssl_triplet_loss(xs[0::3], xs[1::3], xs[2::3])

    _assert_same(*_grad_both(jf, tf, *arrays))
    _assert_same(*_grad_both(jbd.triplet_margin_loss,
                             tbd.triplet_margin_loss, *arrays[:3]))


FRAME = 128


def _detection_case(seed, b=2, k=15):
    rng = np.random.RandomState(seed)
    from opental_tpu.models.pyramid import make_priors
    priors = make_priors(FRAME)
    p = priors.shape[0]
    out = {
        'loc': (rng.rand(b, p, 2) * 30 + 1).astype(np.float32),
        'conf': rng.randn(b, p, k).astype(np.float32) * 2,
        'prop_loc': rng.randn(b, p, 2).astype(np.float32) * 0.3,
        'prop_conf': rng.randn(b, p, k).astype(np.float32) * 2,
        'center': rng.randn(b, p, 1).astype(np.float32),
        'act': rng.randn(b, p, 1).astype(np.float32),
        'prop_act': rng.randn(b, p, 1).astype(np.float32),
    }
    n_max = 4
    truths = np.zeros((b, n_max, 2), np.float32)
    labels = np.zeros((b, n_max), np.int32)
    gt_mask = np.zeros((b, n_max), bool)
    for i in range(b):
        n = rng.randint(1, n_max + 1)
        s = rng.uniform(0, 0.7, n)
        truths[i, :n, 0] = s
        truths[i, :n, 1] = np.clip(s + rng.uniform(0.05, 0.3, n), 0, 1)
        labels[i, :n] = rng.randint(1, k + 1, n)
        gt_mask[i, :n] = True
    return priors, out, truths, labels, gt_mask


@pytest.mark.parametrize('seed', [0, 1])
def test_match_targets(seed):
    priors, out, truths, labels, gt_mask = _detection_case(seed)
    want = jms.match_targets(jnp.asarray(priors), jnp.asarray(out['loc']),
                             jnp.asarray(truths), jnp.asarray(labels),
                             jnp.asarray(gt_mask), FRAME, 0.5)
    got = tms.match_targets(torch.from_numpy(priors),
                            torch.from_numpy(out['loc']),
                            torch.from_numpy(truths),
                            torch.from_numpy(labels),
                            torch.from_numpy(gt_mask), FRAME, 0.5)
    for name in tms.MatchResult._fields:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        if g.dtype.kind == 'i':
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6,
                                       err_msg=name)
    assert (got.conf_t > 0).any() and (got.conf_t == 0).any()


def _loss_cfgs(kind, epoch_gate=10):
    if kind == 'edl_oshead':
        common = dict(num_classes=15, clip_length=FRAME, piou=0.5,
                      os_head=True, act_weight=0.1)
        jedl_cfg = jedl.EDLConfig(num_classes=15, iou_aware=True,
                                  with_ibm=True, ibm_start=epoch_gate)
        tedl_cfg = tedl.EDLConfig(num_classes=15, iou_aware=True,
                                  with_ibm=True, ibm_start=epoch_gate)
        return (jms.LossConfig(cls_type='edl', edl=jedl_cfg, **common),
                tms.LossConfig(cls_type='edl', edl=tedl_cfg, **common))
    common = dict(num_classes=15, clip_length=FRAME, piou=0.5)
    return (jms.LossConfig(cls_type='focal', **common),
            tms.LossConfig(cls_type='focal', **common))


KEYS = ('loc', 'conf', 'prop_loc', 'prop_conf', 'center', 'act', 'prop_act')
TERMS = ('loss_l', 'loss_c', 'loss_prop_l', 'loss_prop_c', 'loss_ct',
         'loss_act', 'loss_prop_act')


@pytest.mark.parametrize('epoch', [9, 10])
@pytest.mark.parametrize('kind', ['edl_oshead', 'focal_closed'])
def test_multisegment_loss(kind, epoch):
    priors, out, truths, labels, gt_mask = _detection_case(7)
    jcfg, tcfg = _loss_cfgs(kind)
    accum = (1.0 + np.random.RandomState(8).rand(50)).astype(np.float32)
    jstate = jedl.EDLState(jnp.asarray(accum), jnp.zeros(50))
    tstate = tedl.EDLState(torch.from_numpy(accum.copy()), torch.zeros(50))
    arrays = [out[key] for key in KEYS]
    # a weighted sum of the terms: each term's gradient is checked
    wts = np.linspace(0.5, 2.0, len(TERMS))
    res = {}

    def jloss(*xs):
        d = dict(zip(KEYS, xs), priors=jnp.asarray(priors))
        return jms.multisegment_loss(
            jcfg, d, jnp.asarray(truths), jnp.asarray(labels),
            jnp.asarray(gt_mask), edl_state=jstate, epoch=jnp.asarray(epoch))

    def jf(*xs):
        losses, _ = jloss(*xs)
        return sum(w * losses[t] for w, t in zip(wts, TERMS))

    def tf(*xs):
        d = dict(zip(KEYS, xs), priors=torch.from_numpy(priors))
        losses, st = tms.multisegment_loss(
            tcfg, d, torch.from_numpy(truths), torch.from_numpy(labels),
            torch.from_numpy(gt_mask), edl_state=tstate, epoch=epoch)
        res['t'] = (losses, st)
        return sum(w * losses[t] for w, t in zip(wts, TERMS))

    _assert_same(*_grad_both(jf, tf, *arrays), what=kind)
    jl, jst = jloss(*[jnp.asarray(a) for a in arrays])
    tl, tst = res['t']
    for term in TERMS:
        np.testing.assert_allclose(float(tl[term].detach()), float(jl[term]),
                                   rtol=RTOL, atol=ATOL, err_msg=term)
    assert float(tl['loss_c']) > 0 and float(tl['loss_ct']) > 0
    if kind == 'edl_oshead':
        np.testing.assert_allclose(tst.weight_accum.detach().numpy(),
                                   np.asarray(jst.weight_accum), rtol=1e-5)
