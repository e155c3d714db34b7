"""`opental_torch.tools.export` on the CPU: the CLI writes a `.pt2` whose
loaded program equals the live forward + decode (rtol 1e-6 / atol 1e-6)
with float32 and with uint8 clips, and with uint8 clips agrees with the
JAX package's serving function (`opental_tpu.tools.export.
build_inference_fn`) at the out_dict parity tolerance (rtol 1e-3, atol
2e-3) on the same weights.

The card's program holds the kernels as `opental::` custom ops. Here the
ops get the plain versions as CPU implementations for the length of a
test, and the model's ops are routed to them: the traced program then
holds 2 boundary-pool nodes per forward (and 1 stem pack with
`model.stem_pallas`), and a train step through the ops (the pool's
autograd formula calls the backward op) equals the plain step. The
card's own program is held in `tests/test_torch_export_cuda.py` and
`chip_smoke.py` phase 33.
"""

import copy
import os

import numpy as np
import pytest
import torch
import yaml

import jax.numpy as jnp

from opental_tpu.config import load_config as jax_load_config
from opental_tpu.tools import export as jax_export
from opental_tpu.tools import test as jax_test

from opental_torch import factory
from opental_torch.config import load_config
from opental_torch.infer.pipeline import InferencePipeline, ingest_windows
from opental_torch.ops import boundary_pool, stem_pack
from opental_torch.tools import export
from opental_torch.train.step import (LossWeights, compute_losses,
                                      device_ingest)

from test_torch_packed_inference import eval_shape_variables
from test_torch_train_step import _torch_batch, make_batch, setup_pair
from torch_suite import suite_policy  # noqa: F401 (autouse)

CLIP, CROP, W = 128, 32, 2
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, 'configs', 'thumos14_opental_final.yaml')


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    """A config at the CPU size (f32) with seeded weights on disk."""
    root = tmp_path_factory.mktemp('export')
    cfg = load_config(CONFIG)
    model = factory.init_weights(factory.build_model(
        cfg, frame_num=CLIP, crop_size=CROP), seed=3)
    ckpt = str(root / 'w.ckpt')
    torch.save(model.state_dict(), ckpt)
    with open(CONFIG) as f:
        raw = yaml.safe_load(f)
    raw['dataset']['testing'].update(clip_length=CLIP, crop_size=CROP)
    raw['model']['compute_dtype'] = 'float32'
    raw['testing']['checkpoint_path'] = ckpt
    path = str(root / 'cfg.yaml')
    with open(path, 'w') as f:
        yaml.safe_dump(raw, f)
    return root, path, model


def inputs(uint8, seed=0):
    rng = np.random.RandomState(seed)
    if uint8:
        return (torch.from_numpy(rng.randint(
            0, 256, (W, CLIP, CROP, CROP, 3)).astype(np.uint8)),
            torch.tensor([CLIP, 70], dtype=torch.int32))
    return (torch.from_numpy(rng.uniform(
        -1, 1, (W, CLIP, CROP, CROP, 3)).astype(np.float32)),)


def live(model, x):
    pipe = InferencePipeline(model, clip_length=CLIP, crop_size=CROP,
                             use_edl=True, os_head=True, device='cpu')
    clips = ingest_windows(*x) if len(x) == 2 else \
        x[0].permute(0, 4, 1, 2, 3).contiguous()
    return pipe.forward_decode(clips)._asdict()


@pytest.mark.parametrize('uint8', [False, True])
def test_cli_program_equals_live_and_jax(setup, uint8, capsys,
                                         monkeypatch):
    root, cfg_path, model = setup
    out = str(root / f'm{int(uint8)}.pt2')
    export.main([cfg_path, '--out', out, '--window_batch', str(W),
                 '--device', 'cpu'] + (['--uint8'] if uint8 else []))
    assert f'W={W}' in capsys.readouterr().out
    x = inputs(uint8)
    got = export.load_exported(out)(*x)
    want = live(model, x)
    assert set(got) == {k for k, v in want.items() if v is not None}
    for k, v in got.items():
        torch.testing.assert_close(v, want[k], rtol=1e-6, atol=1e-6,
                                   msg=lambda m: f'{k}: {m}')
    if not uint8:
        return
    monkeypatch.setattr(jax_test, 'load_variables', eval_shape_variables)
    serve, _ = jax_export.build_inference_fn(
        jax_load_config(cfg_path), W, dtype=jnp.float32, uint8_ingest=True)
    jout = serve(*[jnp.asarray(a.numpy()) for a in x])
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jout[k]),
                                   rtol=1e-3, atol=2e-3, err_msg=k)


@pytest.fixture
def ops_on_cpu(monkeypatch):
    """The custom ops with their plain versions as CPU implementations,
    and the model's ops routed to them."""
    lib = torch.library.Library('opental', 'IMPL')

    def fwd(x, segments, level_t, level_k, with_argmax):
        out, am = boundary_pool.plain_forward_segmented(
            x, segments, tuple(zip(level_t, level_k)), with_argmax)
        return out, (am.to(torch.int32) if with_argmax
                     else torch.empty(0, dtype=torch.int32))

    def bwd(argmax, g, t_len, level_t, level_k):
        return boundary_pool.plain_backward_segmented(
            argmax.long(), g, tuple(zip(level_t, level_k)))

    lib.impl('boundary_max_pool_fwd', fwd, 'CPU')
    lib.impl('boundary_max_pool_bwd', bwd, 'CPU')
    lib.impl('stem_pack96', stem_pack.stem_pack96_plain, 'CPU')
    lib.impl('stem_pack96_v2', stem_pack.stem_pack96_v2_plain, 'CPU')
    monkeypatch.setattr(boundary_pool, '_kernel_route', lambda x: True)
    monkeypatch.setattr(stem_pack, '_kernel_route', lambda x: True)
    yield
    lib._destroy()


@pytest.mark.parametrize('stem_pallas', [False, True])
def test_program_holds_the_custom_ops(setup, ops_on_cpu, stem_pallas):
    _, _, model = setup
    if stem_pallas:
        model = factory.build_model(load_config(
            CONFIG, overrides={'model.stem_pallas': True}),
            frame_num=CLIP, crop_size=CROP)
        model.load_state_dict(setup[2].state_dict())
    flags = factory.model_flags(load_config(CONFIG))
    module = export.serving_module(copy.deepcopy(model), CLIP, flags,
                                   uint8_ingest=True)
    program = export.export_program(module, inputs(True))
    want = {export.POOL_OP: 2}
    if stem_pallas:
        want['opental.stem_pack96_v2'] = 1
    assert export.custom_op_counts(program) == want
    x = inputs(True, seed=1)
    got = program.module()(*x)
    with boundary_pool.force_plain(), stem_pack.force_plain():
        ref = live(model, x)
    for k, v in got.items():
        torch.testing.assert_close(v, ref[k], rtol=1e-6, atol=1e-6)


def test_train_step_through_the_ops(ops_on_cpu):
    """The pool's autograd formula runs the backward op: the loss terms
    and gradients of a step through the ops equal the plain step's (the
    same forward; the autograd graph sums some gradients in another
    order, so the gradients agree within 1e-5)."""
    _, _, tstate, tcfg = setup_pair()
    model = tstate.model.train()
    batch = device_ingest(_torch_batch(make_batch(seed=40)))
    calls = []
    bwd = boundary_pool.boundary_pool_cuda.boundary_max_pool_bwd_op

    def counted(*a):
        calls.append(a[1].shape)
        return bwd(*a)

    def terms_and_grads():
        model.zero_grad(set_to_none=True)
        cost, terms, _ = compute_losses(model, tcfg, LossWeights(), batch,
                                        copy.deepcopy(tstate.edl_state), 11)
        cost.backward()
        return terms, {k: p.grad.clone() for k, p in
                       model.named_parameters() if p.grad is not None}

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(boundary_pool.boundary_pool_cuda,
                   'boundary_max_pool_bwd_op', counted)
        got, got_g = terms_and_grads()
    assert len(calls) == 4
    with boundary_pool.force_plain():
        want, want_g = terms_and_grads()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert set(got_g) == set(want_g)
    for k, g in got_g.items():
        torch.testing.assert_close(g, want_g[k], rtol=1e-5,
                                   atol=1e-5 * want_g[k].abs().max(),
                                   msg=lambda m: f'{k}: {m}')


def test_cli_refuses_without_a_card(setup):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='CUDA'):
        export.main([setup[1], '--out', 'never.pt2'])
    assert not os.path.exists('never.pt2')
