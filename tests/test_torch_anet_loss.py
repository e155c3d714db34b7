"""The port's ActivityNet loss vs the JAX package's on the CPU in float32.

Random out dicts at the small size (63 priors of frame_num 256, 4 known
classes, a batch of 3) and padded GT made with numpy go through
`opental_tpu.losses.anet_multisegment` and the port's
`losses/anet_multisegment.py`. Held: every loss term at rtol 3e-4 (the
JAX package's loss-term tolerance against the reference) and the
gradient of a seeded weighted sum of the terms with respect to every
model output at rtol 3e-4, against `jax.grad`: the IoU target of the
centerness term keeps its gradient, so loc and prop_loc get one through
it. Cases: the shipped exp-form MIB (gate on and off), the focal loss of
`anet_softmax`, a piou > 0 case with the IoU calibration, and the binned
MIB, whose EDL state threads through the batch sample by sample.
"""

import numpy as np
import pytest
import torch

from torch_suite import suite_policy  # noqa: F401 (autouse)

import jax
import jax.numpy as jnp

from opental_tpu.losses import anet_multisegment as jl
from opental_tpu.losses.edl import EDLConfig as JEDLConfig
from opental_tpu.losses.edl import EDLState as JEDLState
from opental_tpu.losses.multisegment import LossConfig as JLossConfig
from opental_tpu.models.anet_pyramid import make_anet_priors

from opental_torch.losses import anet_multisegment as tl
from opental_torch.losses.edl import EDLConfig, EDLState
from opental_torch.losses.multisegment import LossConfig

CLIP, K, B, N_GT = 256, 4, 3, 5
OUTS = ('loc', 'conf', 'prop_loc', 'prop_conf', 'center', 'act',
        'prop_act')
MIB_EXP = dict(num_classes=K, loss_type='log', evidence='exp',
               iou_aware=True, with_ibm=True, ibm_exp=True, ibm_coeff=10.0,
               ibm_start=10)
CASES = {
    # name: (cls_type, os_head, piou, edl config or None, epoch)
    'edl_exp_mib': ('edl', True, 0.0, MIB_EXP, 11),
    'edl_exp_mib_gate_off': ('edl', True, 0.0, MIB_EXP, 9),
    'focal': ('focal', False, 0.0, None, 11),
    'piou': ('edl', True, 0.5, MIB_EXP, 11),
    'binned_mib': ('edl', True, 0.0, dict(MIB_EXP, ibm_exp=False,
                                          ibm_start=0), 11),
}


def make_inputs(os_head, seed):
    """(out dict, truths, labels, gt_mask) as numpy: offsets made like
    the stride-scaled loc (exp of a small logit x the level stride),
    GT spans of every level's range."""
    rng = np.random.RandomState(seed)
    priors = make_anet_priors(CLIP)
    p = priors.shape[0]
    k = K if os_head else K + 1
    stride = np.asarray([4, 8, 16, 32, 64, 128], np.float32)[
        priors[:, 1].astype(int)]
    out = {
        'loc': (np.exp(rng.randn(B, p, 2) * 0.5) * stride[None, :, None]
                * rng.uniform(0.5, 2.0, (B, p, 1))).astype(np.float32),
        'conf': rng.randn(B, p, k).astype(np.float32) * 2,
        'prop_loc': rng.randn(B, p, 2).astype(np.float32) * 0.3,
        'prop_conf': rng.randn(B, p, k).astype(np.float32) * 2,
        'center': rng.randn(B, p, 1).astype(np.float32),
        'act': rng.randn(B, p, 1).astype(np.float32),
        'prop_act': rng.randn(B, p, 1).astype(np.float32),
        'priors': priors,
    }
    truths = np.zeros((B, N_GT, 2), np.float32)
    labels = np.zeros((B, N_GT), np.int32)
    gt_mask = np.zeros((B, N_GT), bool)
    for b in range(B):
        n = rng.randint(1, N_GT + 1) if b else N_GT
        length = rng.choice([20, 50, 100, 180, 240], n) * rng.uniform(
            0.8, 1.2, n)
        start = rng.uniform(0, CLIP - length)
        truths[b, :n, 0] = start / CLIP
        truths[b, :n, 1] = (start + length) / CLIP
        labels[b, :n] = rng.randint(1, K + 1, n)
        gt_mask[b, :n] = True
    return out, truths, labels, gt_mask


def configs(cls_type, os_head, piou, edl):
    common = dict(num_classes=K if os_head else K + 1, clip_length=CLIP,
                  piou=piou, cls_type=cls_type, os_head=os_head,
                  act_margin=1.0, act_weight=0.1, variant='anet')
    jcfg = JLossConfig(edl=None if edl is None else JEDLConfig(**edl),
                       **common)
    tcfg = LossConfig(edl=None if edl is None else EDLConfig(**edl),
                      **common)
    return jcfg, tcfg


@pytest.mark.parametrize('case', sorted(CASES))
def test_terms_and_gradients_match_jax(case):
    cls_type, os_head, piou, edl, epoch = CASES[case]
    jcfg, tcfg = configs(cls_type, os_head, piou, edl)
    out, truths, labels, gt_mask = make_inputs(os_head, seed=len(case))
    weights = np.random.RandomState(7).uniform(0.5, 2.0, len(tl.TERMS))
    binned = edl is not None and not edl['ibm_exp']
    j_state = JEDLState.create(jcfg.edl) if binned else None
    if binned:       # a non-trivial bin state going in
        j_state = j_state._replace(weight_accum=jnp.asarray(
            np.random.RandomState(3).uniform(0.5, 1.5, 50), jnp.float32))

    def jax_total(leaves):
        o = dict(out, **leaves)
        losses, state = jl.anet_multisegment_loss(
            jcfg, o, jnp.asarray(truths), jnp.asarray(labels),
            jnp.asarray(gt_mask), edl_state=j_state,
            epoch=jnp.asarray(epoch))
        total = sum(w * losses[n] for w, n in zip(weights, tl.TERMS))
        return total, (losses, state)

    leaves = {k: jnp.asarray(out[k]) for k in OUTS}
    (_, (j_losses, j_new)), j_grads = jax.value_and_grad(
        jax_total, has_aux=True)(leaves)

    t_leaves = {k: torch.tensor(out[k], requires_grad=True) for k in OUTS}
    t_out = dict(t_leaves, priors=torch.from_numpy(out['priors']))
    t_state = None if j_state is None else EDLState(
        torch.from_numpy(np.array(j_state.weight_accum)),
        torch.from_numpy(np.array(j_state.acc_sum)))
    t_losses, t_new = tl.anet_multisegment_loss(
        tcfg, t_out, torch.from_numpy(truths), torch.from_numpy(labels),
        torch.from_numpy(gt_mask), edl_state=t_state, epoch=epoch)
    sum(float(w) * t_losses[n] for w, n in zip(weights, tl.TERMS)).backward()

    for name in tl.TERMS:
        np.testing.assert_allclose(t_losses[name].item(),
                                   float(j_losses[name]), rtol=3e-4,
                                   atol=1e-6, err_msg=name)
    assert float(j_losses['loss_c']) > 0 and float(j_losses['loss_l']) > 0
    for k in OUTS:
        want = np.asarray(j_grads[k])
        got = (t_leaves[k].grad.numpy() if t_leaves[k].grad is not None
               else np.zeros_like(want))
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=3e-4,
                                   atol=3e-6 * max(scale, 1.0),
                                   err_msg=f'grad {k}')
    if os_head:
        # the centerness IoU target is live: loc and prop_loc get a
        # gradient from loss_ct alone
        loc = t_leaves['loc'].detach().requires_grad_(True)
        prop = t_leaves['prop_loc'].detach().requires_grad_(True)
        only_ct, _ = tl.anet_multisegment_loss(
            tcfg, dict(t_out, loc=loc, prop_loc=prop),
            torch.from_numpy(truths), torch.from_numpy(labels),
            torch.from_numpy(gt_mask), edl_state=t_state, epoch=epoch)
        only_ct['loss_ct'].backward()
        assert prop.grad.abs().sum() > 0 and loc.grad.abs().sum() > 0
    if binned:
        np.testing.assert_allclose(t_new.weight_accum.numpy(),
                                   np.asarray(j_new.weight_accum),
                                   rtol=1e-5)
        assert not np.allclose(t_new.weight_accum.numpy(),
                               np.asarray(j_state.weight_accum))
    else:
        assert t_new is None


def test_priors_set_the_regression_ranges():
    """Each prior's regression range comes from its level index."""
    priors = torch.from_numpy(make_anet_priors(CLIP))
    lb, rb = tl.prior_bounds(priors)
    assert lb.shape == rb.shape == (63,)
    assert lb[0] == 0 and rb[0] == 30 and lb[-1] == 256 and rb[-1] == 768
    assert (lb[32:48] == 15).all() and (rb[32:48] == 60).all()
