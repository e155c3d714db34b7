"""Remat on the data mesh with train-mode BN: each backbone block's
recompute in the backward reduces BN's sums across the ranks again and
leaves the running statistics as one pass leaves them. Two gloo ranks
take one `freeze_bn: false`, `model.remat` step on a global batch of 4;
one process takes it on the whole batch. Held: the mesh test's
tolerances (`assert_same_step`), the running statistics equal on both
ranks and within rtol 1e-4 / atol 1e-5 of one process's.
"""

import copy

import torch

from opental_torch.losses.edl import EDLState
from opental_torch.models.bdnet import BDNet
from opental_torch.parallel.dryrun import (Ranks, assert_same_step,
                                           grad_gaps, step_record)
from opental_torch.train.step import (LossWeights, TrainState,
                                      make_optimizer, train_step)

from test_torch_mesh_train import (CROP, EPOCH, FRAME, LR, WD, WORLD,
                                   jax_variables, mesh_batch, port_loss,
                                   port_model, train_job)
from torch_suite import suite_policy  # noqa: F401 (autouse)


def test_remat_with_global_batch_norm(tmp_path, record_property):
    # the numpy variables of the JAX comparisons (every BN scale and bias
    # off its init): at the seeded training init, train-mode BN makes the
    # step so sensitive to summation order that rotating the batch's rows
    # in one process moves the grad norm by 5e-4 to 7e-4
    model = BDNet(num_classes=16, os_head=True, use_edl=True,
                  frame_num=FRAME, crop_size=CROP, freeze_bn=False,
                  remat=True)
    model.load_state_dict(port_model(jax_variables(False)[1],
                                     False).state_dict())
    batch = mesh_batch(seed=50)
    ranks = Ranks(WORLD, [train_job(model, batch)], root=str(tmp_path))
    one = copy.deepcopy(model)
    state = TrainState(model=one, optimizer=make_optimizer(one, LR, WD),
                       edl_state=EDLState.create(port_loss().edl))
    want = step_record(state, train_step(
        state, port_loss(), LossWeights(),
        {k: torch.from_numpy(v) for k, v in batch.items()}, EPOCH))
    got = [r[0] for r in ranks.results()]
    record_property('grad_gaps', grad_gaps(want['grads'], got[0]['grads']))
    n_stats = 0
    for rank, res in enumerate(got):
        assert_same_step(want, res, f'rank {rank}')
        for k, x in res['buffers'].items():
            if k.endswith(('running_mean', 'running_var')):
                assert torch.equal(x, got[0]['buffers'][k]), (rank, k)
                torch.testing.assert_close(
                    x, want['buffers'][k], rtol=1e-4, atol=1e-5,
                    msg=lambda m: f'rank {rank} {k}: {m}')
                n_stats += 1
    assert n_stats > 200
    moved = 'backbone._model.Conv3d_1a_7x7.bn.running_mean'
    assert not torch.equal(want['buffers'][moved],
                           model.state_dict()[moved])
