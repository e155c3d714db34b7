"""The kernels' `torch.library` custom ops and the single-device slice on
the card: `torch.library.opcheck` of each op (schema, fake
implementation, autograd registration), gradients through the pool's op
against the plain version, an exported program that holds the ops and
equals the live forward + decode, remat and the fused SSL step. This
file imports neither JAX nor the JAX package, so that it also runs where
only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_export_cuda.py

Without a card its tests skip (a CUDA kernel has no CPU mode).
"""

import copy

import pytest
import torch

from opental_torch import factory
from opental_torch.config import load_config
from opental_torch.infer.pipeline import InferencePipeline, ingest_windows
from opental_torch.losses.edl import EDLState
from opental_torch.models.pyramid import level_sizes
from opental_torch.ops import (boundary_pool, boundary_pool_cuda,
                               max_pool3d_cuda, stem_pack_cuda)
from opental_torch.tools import export
from opental_torch.train.step import compute_losses, device_ingest

CONFIG = 'configs/thumos14_opental_final.yaml'
FRAMES, CROP = 128, 64


def need_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernels have no CPU mode')


def pool_case(seed=0):
    g = torch.Generator(device='cuda').manual_seed(seed)
    levels = tuple((t, t) for t in level_sizes(256))
    t_all = sum(t for t, _ in levels)
    x = torch.randn(2, t_all, 64, generator=g, device='cuda')
    seg = (torch.rand(2, t_all, 4, generator=g, device='cuda') * 40 - 5)
    return x, seg, levels


@pytest.mark.cuda
def test_opcheck_every_op():
    need_card()
    x, seg, levels = pool_case()
    lt, lk = [t for t, _ in levels], [k for _, k in levels]
    for argmax in (False, True):
        torch.library.opcheck(boundary_pool_cuda.boundary_max_pool_fwd_op,
                              (x.requires_grad_(argmax), seg, lt, lk,
                               argmax))
    _, am = boundary_pool_cuda.boundary_max_pool_fwd(x.detach(), seg, True,
                                                     levels)
    g = torch.randn_like(x[:, :seg.shape[1]])
    torch.library.opcheck(boundary_pool_cuda.boundary_max_pool_bwd_op,
                          (am, g, x.shape[1], lt, lk))
    xp = torch.randn(1, 3, 20, 18, 18, device='cuda').permute(0, 2, 3, 4, 1)
    torch.library.opcheck(stem_pack_cuda.stem_pack96_op, (xp, 4))
    torch.library.opcheck(stem_pack_cuda.stem_pack96_v2_op, (xp, 4, 1))
    v = torch.randn(2, 3, 7, 9, 10, device='cuda', dtype=torch.bfloat16)
    for kernel, stride in max_pool3d_cuda.SPECS:
        torch.library.opcheck(max_pool3d_cuda.max_pool3d_same_op,
                              (v, list(kernel), list(stride)))


@pytest.mark.cuda
def test_gradient_through_the_op_equals_plain():
    need_card()
    x, seg, levels = pool_case(1)
    outs = []
    for plain in (False, True):
        xx = x.clone().requires_grad_(True)
        f0, b0 = boundary_pool_cuda.LAUNCHES, boundary_pool_cuda.BWD_LAUNCHES
        if plain:
            with boundary_pool.force_plain():
                y = boundary_pool.boundary_max_pool_segmented(xx, seg,
                                                              levels)
        else:
            y = boundary_pool.boundary_max_pool_segmented(xx, seg, levels)
        (y * torch.arange(y.numel(), device='cuda').view_as(y) / 64).sum(
            ).backward()
        launched = (boundary_pool_cuda.LAUNCHES - f0,
                    boundary_pool_cuda.BWD_LAUNCHES - b0)
        assert launched == ((0, 0) if plain else (1, 1)), launched
        outs.append((y.detach(), xx.grad))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


@pytest.mark.cuda
@pytest.mark.parametrize('stem_pallas', [False, True])
def test_exported_program_holds_the_ops(tmp_path, stem_pallas):
    need_card()
    cfg = load_config(CONFIG, overrides={'model.stem_pallas': stem_pallas})
    model = factory.init_weights(factory.build_model(
        cfg, frame_num=FRAMES, crop_size=CROP, dtype=torch.float32), seed=1)
    module = export.serving_module(copy.deepcopy(model), FRAMES,
                                   factory.model_flags(cfg),
                                   uint8_ingest=True, device='cuda')
    inputs = export.example_inputs(4, FRAMES, CROP, 3, True,
                                   torch.device('cuda'))
    program = export.export_program(module, inputs)
    want = {export.POOL_OP: 2, 'opental.max_pool3d_same': 13}
    if stem_pallas:
        want['opental.stem_pack96_v2'] = 1
    assert export.custom_op_counts(program) == want
    path = str(tmp_path / 'm.pt2')
    torch.export.save(program, path)
    loaded = export.load_exported(path)
    g = torch.Generator(device='cuda').manual_seed(2)
    clips = torch.randint(0, 256, inputs[0].shape, generator=g,
                          device='cuda', dtype=torch.uint8)
    valid = torch.tensor([FRAMES, FRAMES, 50, FRAMES], dtype=torch.int32,
                         device='cuda')
    pipe = InferencePipeline(model, clip_length=FRAMES, crop_size=CROP,
                             use_edl=True, os_head=True, device='cuda')
    torch.backends.cudnn.deterministic = True
    allow = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        f0 = boundary_pool_cuda.LAUNCHES
        got = loaded(clips, valid)
        assert boundary_pool_cuda.LAUNCHES - f0 == 2
        want_dec = pipe.forward_decode(ingest_windows(clips, valid))
    finally:
        torch.backends.cudnn.deterministic = False
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = allow
    for k, v in got.items():
        torch.testing.assert_close(v, getattr(want_dec, k), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize('flag', ['model.remat', 'fuse_ssl'])
def test_remat_and_fused_step_on_card(flag):
    """The loss terms of one step with remat / the fused SSL pass equal
    the plain step's; B1 and B2 launch 4 times each."""
    need_card()
    cfg = load_config(CONFIG)
    base = factory.init_train_weights(factory.build_model(
        cfg, frame_num=FRAMES, crop_size=CROP), seed=0).cuda()
    other = base
    if flag == 'model.remat':
        other = factory.build_model(load_config(
            CONFIG, overrides={flag: True}), frame_num=FRAMES,
            crop_size=CROP).cuda()
        other.load_state_dict(base.state_dict())
    g = torch.Generator(device='cuda').manual_seed(3)
    batch = {
        'clips': torch.randint(0, 256, (1, FRAMES, CROP, CROP, 3),
                               generator=g, device='cuda',
                               dtype=torch.uint8),
        'ssl_clips': torch.randint(0, 256, (1, FRAMES, CROP, CROP, 3),
                                   generator=g, device='cuda',
                                   dtype=torch.uint8),
        'truths': torch.tensor([[[0.1, 0.3], [0.5, 0.9]]], device='cuda'),
        'labels': torch.tensor([[3, 7]], device='cuda'),
        'gt_mask': torch.ones(1, 2, dtype=torch.bool, device='cuda'),
        'scores': (torch.rand(1, 2, FRAMES, generator=g, device='cuda')
                   > 0.9).float(),
        'ssl_props': torch.tensor([[[10., 40.], [60., 100.], [45., 55.]]],
                                  device='cuda'),
        'ssl_flags': torch.ones(1, device='cuda')}
    loss_cfg = factory.build_loss_config(cfg)
    weights = factory.build_loss_weights(cfg)
    terms = []
    for model, fuse in ((base, False), (other, flag == 'fuse_ssl')):
        model.train()
        f0, b0 = boundary_pool_cuda.LAUNCHES, boundary_pool_cuda.BWD_LAUNCHES
        cost, t, _ = compute_losses(model, loss_cfg, weights,
                                    device_ingest(batch),
                                    EDLState.create(loss_cfg.edl, 'cuda'),
                                    11, fuse_ssl=fuse)
        cost.backward()
        assert (boundary_pool_cuda.LAUNCHES - f0,
                boundary_pool_cuda.BWD_LAUNCHES - b0) == (4, 4)
        terms.append({k: v.detach() for k, v in t.items()})
    for k, v in terms[0].items():
        torch.testing.assert_close(terms[1][k], v, rtol=2e-4, atol=1e-6)
