"""The port's ActivityNet BDNet vs the JAX package's on the CPU in float32.

At the small size frame_num 256, crop 32 (levels of 32 down to 1 rows,
63 priors), with os_head + EDL and 4 known classes. The flax variables
take the init's shapes (`jax.eval_shape`) and seeded numpy values, and
reach the port through `utils/convert.from_jax_variables` with
`load_state_dict(strict=True)`. Held: the out_dict at rtol 1e-3 / atol
2e-3 (the JAX package's BDNet tolerance against the reference), the
priors exactly, two grouped pool calls per forward (counted through the
plain version) and none in the SSL pass, the ANet head re-init's
statistics, and the three shipped ANet configs building and loading a
converted flax tree through both factories with the same loss config.
"""

import numpy as np
import pytest
import torch

from torch_suite import suite_policy  # noqa: F401 (autouse)

import jax
import jax.numpy as jnp

from opental_tpu import factory as jax_factory
from opental_tpu.config import load_config as jax_load_config
from opental_tpu.models import anet_pyramid as jax_anet
from opental_tpu.models.bdnet import BDNet as JBDNet

from opental_torch import factory
from opental_torch.config import load_config
from opental_torch.models import anet_pyramid, pyramid
from opental_torch.models.bdnet import BDNet
from opental_torch.utils.convert import from_jax_variables

FRAME, CROP, CLASSES = 256, 32, 5
OUT_KEYS = ('loc', 'conf', 'prop_loc', 'prop_conf', 'center', 'act',
            'prop_act', 'start', 'end', 'start_loc_prop', 'end_loc_prop',
            'start_conf_prop', 'end_conf_prop', 'unct', 'prop_unct')
CONFIGS = ('configs/anet_opental.yaml', 'configs/anet_edl.yaml',
           'configs/anet_softmax.yaml')


def numpy_variables(shapes, seed=0):
    """Glorot-uniform kernels and every other leaf moved off its init
    value, made with numpy for the tree of shapes `shapes`."""
    rng = np.random.RandomState(seed)

    def f(path, s):
        name = path[-1].key
        if name == 'kernel':
            rf = int(np.prod(s.shape[:-2]))
            lim = np.sqrt(6.0 / ((s.shape[-2] + s.shape[-1]) * rf))
            return rng.uniform(-lim, lim, s.shape).astype(np.float32)
        base = 1.0 if name in ('scale', 'var') else 0.0
        return (base + rng.uniform(0.05, 0.3, s.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(f, shapes)


def init_shapes(model, channels=3):
    return dict(jax.eval_shape(model.init, jax.random.PRNGKey(0),
                               jnp.zeros((1, FRAME, CROP, CROP, channels),
                                         jnp.float32)))


@pytest.fixture(scope='module')
def pair():
    jm = JBDNet(num_classes=CLASSES, os_head=True, use_edl=True,
                frame_num=FRAME, arch='anet')
    v = numpy_variables(init_shapes(jm))
    tm = BDNet(num_classes=CLASSES, os_head=True, use_edl=True,
               frame_num=FRAME, crop_size=CROP, arch='anet').eval()
    tm.load_state_dict(from_jax_variables(v), strict=True)
    x = np.random.RandomState(1).uniform(
        -1, 1, (2, FRAME, CROP, CROP, 3)).astype(np.float32)
    want = jax.jit(jm.apply)(v, jnp.asarray(x))
    return tm, x, jax.tree_util.tree_map(np.asarray, want)


def test_out_dict_matches_jax(pair):
    tm, x, want = pair
    with torch.no_grad():
        got = tm(torch.from_numpy(x.transpose(0, 4, 1, 2, 3).copy()))
    for key in OUT_KEYS:
        g, w = got[key].numpy(), want[key]
        assert g.shape == w.shape, (key, g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=2e-3, err_msg=key)
    assert got['loc'].shape == (2, 63, 2)
    # the stride-scaled offsets reach the coarsest level's 128
    assert got['loc'][:, -1].abs().max() > 20


def test_priors_exact(pair):
    tm, _, want = pair
    priors = tm.coarse_pyramid_detection.priors.numpy()
    np.testing.assert_array_equal(priors, want['priors'])
    np.testing.assert_array_equal(priors, jax_anet.make_anet_priors(FRAME))
    np.testing.assert_array_equal(anet_pyramid.make_anet_priors(768),
                                  jax_anet.make_anet_priors(768))
    assert anet_pyramid.make_anet_priors(768).shape == (189, 2)
    assert anet_pyramid.FPN_STRIDES == jax_anet.FPN_STRIDES
    assert anet_pyramid.LEVEL_BOUNDS == jax_anet.LEVEL_BOUNDS


def test_two_pool_calls_per_forward(pair, monkeypatch):
    """The frame-level pool of all 63 windows and the lr pool of the 12
    levels (32 .. 1 rows, loc and conf), through the plain version on the
    CPU; the SSL pass pools nothing in the pyramid."""
    tm, x, _ = pair
    calls = []
    real = pyramid.boundary_max_pool_segmented

    def counting(xx, seg, levels):
        calls.append((tuple(xx.shape), levels))
        return real(xx, seg, levels)

    monkeypatch.setattr(pyramid, 'boundary_max_pool_segmented', counting)
    xt = torch.from_numpy(x[:1].transpose(0, 4, 1, 2, 3).copy())
    with torch.no_grad():
        tm(xt)
        assert len(calls) == 2, calls
        sizes = (32, 16, 8, 4, 2, 1)
        assert calls[0] == ((1, FRAME, 512), ((FRAME, 63),))
        assert calls[1] == ((1, 126, 1024), tuple((t, t) for t in sizes) * 2)
        trip = tm.coarse_pyramid_detection(tm.backbone(xt), ssl=True)
    assert len(calls) == 2
    assert [tuple(t.shape) for t in trip['trip']] == [
        (1, FRAME, 512), (1, 32, 1024), (1, 32, 1024)]


def test_reinit_statistics(monkeypatch):
    """init_train_weights on an ANet BDNet: normal(0, 0.01) weights and
    zero biases on every Conv1d of the nine groups; every other parameter
    as the glorot init left it (the same seed without the re-init)."""
    def build():
        return BDNet(num_classes=CLASSES, os_head=True, use_edl=True,
                     frame_num=FRAME, crop_size=CROP, arch='anet')

    model = factory.init_train_weights(build(), seed=3)
    with monkeypatch.context() as m:
        m.setattr(factory, 'reinit_anet_heads', lambda *a, **k: None)
        base = dict(factory.init_train_weights(build(),
                                               seed=3).named_parameters())
    reinit, touched = set(), set()
    for name, mod in model.coarse_pyramid_detection.named_modules():
        group = name.split('.')[0]
        if isinstance(mod, torch.nn.Conv1d) \
                and group in anet_pyramid.ANET_REINIT_MODULES:
            touched.add(group)
            w = mod.weight.detach()
            assert abs(w.std().item() - 0.01) < 0.004, (name, w.std())
            assert abs(w.mean().item()) < 0.005, name
            assert torch.count_nonzero(mod.bias) == 0, name
            reinit |= {f'coarse_pyramid_detection.{name}.weight',
                       f'coarse_pyramid_detection.{name}.bias'}
    assert touched == set(anet_pyramid.ANET_REINIT_MODULES)
    for name, p in model.named_parameters():
        if name not in reinit:      # GroupNorm, ScaleExp, other convs
            torch.testing.assert_close(p, base[name], rtol=0, atol=0,
                                       msg=name)
    assert len(reinit) > 20


@pytest.mark.parametrize('path', CONFIGS)
def test_shipped_configs_build_and_load(path):
    """Both factories build the config's ANet BDNet (at the small size);
    the flax tree converts onto the port with strict=True; the loss
    configs agree field by field (exp-form MIB and variant 'anet')."""
    jm = jax_factory.build_model(jax_load_config(path), frame_num=FRAME)
    assert jm.arch == 'anet'
    cfg = load_config(path)
    tm = factory.build_model(cfg, frame_num=FRAME, crop_size=CROP)
    assert tm.arch == 'anet'
    assert isinstance(tm.coarse_pyramid_detection,
                      anet_pyramid.AnetCoarsePyramid)
    v = numpy_variables(init_shapes(jm))
    tm.load_state_dict(from_jax_variables(v), strict=True)
    jl = jax_factory.build_loss_config(jax_load_config(path))
    tl = factory.build_loss_config(cfg)
    assert tl.variant == jl.variant == 'anet'
    for field in tl._fields:
        if field == 'edl':
            assert (tl.edl is None) == (jl.edl is None)
            if tl.edl is not None:
                assert tl.edl._asdict() == jl.edl._asdict()
        else:
            assert getattr(tl, field) == getattr(jl, field), field
    if path.endswith('anet_opental.yaml'):
        assert tl.edl.ibm_exp and tl.edl.ibm_coeff == 10.0
