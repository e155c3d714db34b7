"""The `model.stem_pallas` path as a whole, on the CPU in float32.

* Port `BDNet(stem_pallas=True)` vs JAX `BDNet(stem_pallas=True)` (its
  Pallas stem pack in interpret mode) at frame 128 / crop 32, on one set
  of flax variables (init shapes from `jax.eval_shape`, seeded numpy
  values) carried over with `from_jax_variables`: I3D endpoints at atol
  2e-4, the out_dict at rtol 1e-3 / atol 2e-3 (the JAX package's
  tolerances against the reference).
* One port train step (losses and gradients) with the flag on vs off on
  the same weights and batch: every loss term at rtol 1e-4; the stem
  weight's gradient, on the upstream gradient the flag-off step sends
  the stem, at rtol 1e-4 (plus 1e-4 of its largest entry). The two
  compute the same convolution in another order, and that ~1e-7 change
  flips near-tied max-pool and ReLU choices downstream: over the whole
  step the stem gradients differ by ~1.5e-3 of their norm, as much as a
  1e-7 relative change of the input alone moves the flag-off gradient;
  that is held at 1e-2.
* The stem runs through the pack once per forward (v2) and twice per
  train step (the main pass and the SSL pass, v1: the layout the stem
  takes when its weight needs a gradient).
"""

import copy
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from opental_tpu.models import bdnet as jb
from opental_tpu.ops import stem_pack_pallas as jsp

from opental_torch.losses.edl import EDLConfig, EDLState
from opental_torch.losses.multisegment import LossConfig
from opental_torch.models import bdnet as tb
from opental_torch.ops import stem_pack
from opental_torch.train.step import (LossWeights, compute_losses,
                                      device_ingest)
from opental_torch.utils.convert import from_jax_variables

from test_torch_bdnet import OUT_KEYS
from test_torch_train_step import EDL, LOSS, make_batch, numpy_variables
from torch_suite import suite_policy  # noqa: F401 (autouse)

FRAMES, CROP = 128, 32


@pytest.fixture(scope='module')
def variables():
    jm = jb.BDNet(num_classes=16, os_head=True, use_edl=True,
                  frame_num=FRAMES, stem_pallas=True)
    x0 = jnp.zeros((1, FRAMES, CROP, CROP, 3), jnp.float32)
    return jm, numpy_variables(dict(jax.eval_shape(
        jm.init, jax.random.PRNGKey(0), x0)))


@pytest.fixture(scope='module')
def forward_pair(variables):
    jm, v = variables
    x = np.random.RandomState(0).randn(2, FRAMES, CROP, CROP, 3).astype(
        np.float32) * 0.5
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsp, 'stem_conv_v2', functools.partial(
            jsp.stem_conv_v2, interpret=True))
        # one compile: the backbone's endpoints come out as intermediates
        want, state = jax.jit(lambda vv, xx: jm.apply(
            vv, xx, capture_intermediates=lambda mdl, name:
            mdl.name == 'backbone' and name == '__call__',
            mutable=['intermediates']))(v, jnp.asarray(x))
        (want_feat,) = state['intermediates']['backbone']['__call__']
    tm = tb.BDNet(num_classes=16, os_head=True, use_edl=True,
                  frame_num=FRAMES, crop_size=CROP, stem_pallas=True).eval()
    tm.load_state_dict(from_jax_variables(v), strict=True)
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 4, 1, 2, 3)))
    calls = count_packs()
    with torch.no_grad(), calls:
        got_feat = tm.backbone(xt)
        got = tm.detect_from_features(got_feat)
    return want_feat, want, got_feat, got, calls.n


class count_packs:
    """Counts the packs the port's stem makes, by layout, while active."""

    def __enter__(self):
        self.n = {'v1': 0, 'v2': 0}
        self.mp = pytest.MonkeyPatch()
        for key, name in (('v1', 'stem_pack96'), ('v2', 'stem_pack96_v2')):
            real = getattr(stem_pack, name)

            def counted(*a, real=real, key=key, **k):
                self.n[key] += 1
                return real(*a, **k)
            self.mp.setattr(stem_pack, name, counted)
        return self

    def __exit__(self, *exc):
        self.mp.undo()


def test_i3d_endpoints_flag_on(forward_pair):
    want_feat, _, got_feat, _, packs = forward_pair
    assert packs == {'v1': 0, 'v2': 1}, 'one v2 pack per forward'
    for ep in ('Mixed_4f', 'Mixed_5c'):
        g = np.moveaxis(got_feat[ep].numpy(), 1, -1)
        w = np.asarray(want_feat[ep])
        assert g.shape == w.shape, (ep, g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-4, err_msg=ep)


def test_out_dict_flag_on(forward_pair):
    _, want, _, got, _ = forward_pair
    for key in OUT_KEYS:
        g, w = got[key].numpy(), np.asarray(want[key])
        assert g.shape == w.shape, (key, g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=2e-3, err_msg=key)


def step_losses_and_stem_grad(v, stem_pallas, batch):
    """Loss terms, the stem weight's gradient and the pack count of one
    step; and the stem module with the input and upstream gradient of its
    main-pass call."""
    tm = tb.BDNet(num_classes=16, os_head=True, use_edl=True,
                  frame_num=FRAMES, crop_size=CROP, stem_pallas=stem_pallas)
    tm.load_state_dict(from_jax_variables(v), strict=True)
    tm.train()
    stem = tm.backbone._model.Conv3d_1a_7x7
    seen = {}

    def capture(mod, args, out):
        if 'x' not in seen:
            seen['x'] = args[0].detach()
            out.register_hook(lambda g: seen.setdefault('g', g.detach()))
    stem.register_forward_hook(capture)
    cfg = LossConfig(edl=EDLConfig(**EDL), **LOSS)
    calls = count_packs()
    with calls:
        cost, terms, _ = compute_losses(
            tm, cfg, LossWeights(), batch, EDLState.create(cfg.edl), 11)
        cost.backward()
    return ({k: float(t) for k, t in terms.items()},
            stem.conv3d.weight.grad.numpy(), calls.n,
            (stem, seen['x'], seen['g']))


def test_train_step_flag_on_vs_off(variables):
    _, v = variables
    batch = device_ingest({k: torch.from_numpy(a)
                           for k, a in make_batch(seed=21).items()})
    on, grad_on, packs_on, _ = step_losses_and_stem_grad(v, True, batch)
    off, grad_off, packs_off, (stem, x, g) = step_losses_and_stem_grad(
        v, False, batch)
    # the main pass and the SSL pass, in the layout of training
    assert packs_on == {'v1': 2, 'v2': 0}, packs_on
    assert packs_off == {'v1': 0, 'v2': 0}, packs_off
    assert on['loss_trip'] > 0
    for k in off:
        np.testing.assert_allclose(on[k], off[k], rtol=1e-4, atol=1e-7,
                                   err_msg=k)
    assert np.linalg.norm(grad_on - grad_off) <= \
        1e-2 * np.linalg.norm(grad_off)
    grads = []
    for s2d in (True, False):
        mod = copy.deepcopy(stem)
        mod.space_to_depth = s2d
        mod.zero_grad()
        (mod(x) * g).sum().backward()
        grads.append(mod.conv3d.weight.grad.numpy())
    np.testing.assert_allclose(grads[0], grads[1], rtol=1e-4,
                               atol=1e-4 * np.abs(grads[1]).max())
