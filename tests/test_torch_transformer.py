"""The transformer conf head (`model.transformer`) of the port vs the JAX
package's, on the CPU in float32: the encoder layer and the head at
1e-5, and the whole BDNet's out_dict at the parity tolerance (rtol 1e-3,
atol 2e-3) in eval mode, on flax variables carried over by
`from_jax_variables`; then a port train step with the head."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from opental_tpu.models import bdnet as jb
from opental_tpu.models import layers as jl

from opental_torch import factory
from opental_torch.losses.edl import EDLConfig, EDLState
from opental_torch.losses.multisegment import LossConfig
from opental_torch.models import bdnet as tb
from opental_torch.models import layers as tl
from opental_torch.train.step import (LossWeights, TrainState,
                                      make_optimizer, train_step)
from opental_torch.utils.convert import from_jax_variables, map_jax_path

from test_torch_train_step import EDL, LOSS, make_batch, numpy_variables
from torch_suite import suite_policy  # noqa: F401 (autouse)

FRAMES, CROP, D = 128, 32, 512
OUT_KEYS = ('loc', 'conf', 'prop_loc', 'prop_conf', 'center', 'act',
            'prop_act', 'unct', 'prop_unct')


def _head_state_dict(params, prefix):
    """A head's flax params through the BDNet key map, stripped of the
    pyramid prefix."""
    sd = from_jax_variables({'params': {'pyramid': {'conf_head': params}}})
    return {k[len(prefix):]: v for k, v in sd.items()}


def _spread(params, seed):
    """A flax init with its biases and LayerNorm scales moved off their
    init values (0 / 1), the kernels as drawn (as
    `test_torch_bdnet._spread`)."""
    rng = np.random.RandomState(seed)

    def f(path, a):
        a = np.asarray(a)
        if path[-1].key == 'kernel':
            return a
        return a + rng.uniform(-0.2, 0.2, a.shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(f, params)


def test_positional_encoding():
    np.testing.assert_allclose(tl.positional_encoding(37, 64).numpy(),
                               np.asarray(jl.positional_encoding(37, 64)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('which', ['layer', 'head'])
def test_layer_and_head_match_jax(which):
    x = np.random.RandomState(0).randn(2, 16, D).astype(np.float32)
    if which == 'layer':
        jm = jl.TransformerEncoderLayer(d_model=D, d_ff=D // 2)
        tm = tl.TransformerEncoderLayer(D, 8, D // 2)
    else:
        jm = jl.TransformerHead(num_classes=15)
        tm = tl.TransformerHead(15, D)
    params = _spread(jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
                     ['params'], seed=2)
    if which == 'layer':
        sd = _head_state_dict({'TransformerEncoderLayer_0': params},
                              'coarse_pyramid_detection.conf_head.'
                              'layers.0.')
    else:
        sd = _head_state_dict(params, 'coarse_pyramid_detection.'
                                      'conf_head.')
    tm.load_state_dict(sd, strict=True)
    want = np.asarray(jm.apply({'params': params}, jnp.asarray(x)))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_layer_norm_eps_is_flax():
    layer = tl.TransformerEncoderLayer(D)
    assert layer.norm1.eps == layer.norm2.eps == 1e-6


def test_key_map():
    base = ('pyramid', 'conf_head', 'TransformerEncoderLayer_1')
    p = 'coarse_pyramid_detection.conf_head.'
    assert map_jax_path(base + ('MultiHeadDotProductAttention_0', 'value',
                                'bias')) == (
        p + 'layers.1.self_attn.in_proj_bias', 'qkv_bias:value')
    assert map_jax_path(base + ('Dense_1', 'kernel')) == (
        p + 'layers.1.linear2.weight', 'dense')
    assert map_jax_path(('pyramid', 'conf_head', 'Dense_0', 'bias')) == (
        p + 'fc.bias', None)
    with pytest.raises(KeyError):
        map_jax_path(base + ('MultiHeadDotProductAttention_0', 'gate',
                             'kernel'))
    # a layer's in_proj needs all three of query, key and value
    params = {'TransformerEncoderLayer_0': {
        'MultiHeadDotProductAttention_0': {
            'query': {'kernel': np.zeros((D, 8, 64), np.float32)},
            'key': {'kernel': np.zeros((D, 8, 64), np.float32)}}}}
    with pytest.raises(KeyError, match='value'):
        from_jax_variables({'params': {'pyramid': {'conf_head': params}}})


@pytest.fixture(scope='module')
def bdnets():
    jm = jb.BDNet(num_classes=16, os_head=True, use_edl=True,
                  frame_num=FRAMES, transformer=True)
    x0 = jnp.zeros((1, FRAMES, CROP, CROP, 3), jnp.float32)
    v = numpy_variables(dict(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                            x0)), seed=5)
    tm = tb.BDNet(num_classes=16, os_head=True, use_edl=True,
                  frame_num=FRAMES, crop_size=CROP, transformer=True)
    tm.load_state_dict(from_jax_variables(v), strict=True)
    return jm, v, tm


def test_bdnet_out_dict_matches_jax(bdnets):
    jm, v, tm = bdnets
    x = np.random.RandomState(3).uniform(
        -1, 1, (2, FRAMES, CROP, CROP, 3)).astype(np.float32)
    want = jax.jit(jm.apply)(v, jnp.asarray(x))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(
            np.ascontiguousarray(x.transpose(0, 4, 1, 2, 3))))
    assert isinstance(tm.coarse_pyramid_detection.conf_head,
                      tl.TransformerHead)
    for key in OUT_KEYS:
        g, w = got[key].numpy(), np.asarray(want[key])
        assert g.shape == w.shape, (key, g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=2e-3, err_msg=key)


def test_bf16_model_keeps_the_head_in_f32():
    tm = tb.BDNet(num_classes=16, os_head=True, use_edl=True,
                  frame_num=FRAMES, crop_size=CROP, transformer=True,
                  dtype=torch.bfloat16).eval()
    x = torch.from_numpy(np.random.RandomState(4).uniform(
        -1, 1, (1, 3, FRAMES, CROP, CROP)).astype(np.float32))
    with torch.no_grad():
        out = tm(x)
    assert out['conf'].dtype == torch.float32
    assert out['prop_conf'].dtype == torch.bfloat16
    assert torch.isfinite(out['conf']).all()


def test_train_step_moves_the_head():
    """A port train step (dropout 0.1 inside the head in train mode)
    gives every head parameter a gradient and a finite cost."""
    torch.manual_seed(0)
    tm = tb.BDNet(num_classes=16, os_head=True, use_edl=True,
                  frame_num=FRAMES, crop_size=CROP, transformer=True)
    factory.init_train_weights(tm, seed=0)
    head = tm.coarse_pyramid_detection.conf_head
    before = {k: p.detach().clone() for k, p in head.named_parameters()}
    state = TrainState(model=tm, optimizer=make_optimizer(tm, 1e-3, 1e-3),
                       edl_state=EDLState.create(EDLConfig(**EDL)))
    batch = {k: torch.from_numpy(a) for k, a in make_batch(7).items()}
    metrics = train_step(state, LossConfig(edl=EDLConfig(**EDL), **LOSS),
                         LossWeights(), batch, 11)
    assert torch.isfinite(metrics['cost'])
    for k, p in head.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), k
        assert not torch.equal(p.detach(), before[k]), k


def test_rpl_with_transformer_is_refused():
    """The JAX pyramid reads the RPL centers off its conf head, which a
    transformer head has none of: its init fails. The port refuses the
    combination when it builds the model."""
    jm = jb.BDNet(num_classes=16, use_rpl=True, transformer=True,
                  frame_num=FRAMES)
    with pytest.raises(KeyError, match='centers'):
        jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                       jnp.zeros((1, FRAMES, CROP, CROP, 3)))
    with pytest.raises(ValueError, match='use_rpl'):
        tb.BDNet(num_classes=16, use_rpl=True, transformer=True,
                 frame_num=FRAMES, crop_size=CROP)
