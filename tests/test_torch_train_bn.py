"""One `freeze_bn: false` train step of the port vs the JAX package's, on
the CPU in float32, from one set of flax variables
(`test_torch_train_step.py`'s setup): BN normalizes by batch statistics in both passes, EMA-updates its
running statistics and trains gamma / beta. Held: the loss terms and cost
at rtol 3e-4, the running statistics at rtol 1e-4 / atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from opental_torch.train.step import LossWeights, train_step
from opental_torch.utils.convert import from_jax_variables

from test_torch_train_step import TERMS, _torch_batch, make_batch, setup_pair
from torch_suite import suite_policy  # noqa: F401 (autouse)


def test_train_mode_batchnorm_step():
    """freeze_bn: false: BN normalizes by batch statistics in both passes
    and EMA-updates its running statistics; gamma / beta train."""
    jstate, jstep, tstate, tcfg = setup_pair(freeze_bn=False)
    batch = make_batch(seed=20)
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                       jnp.asarray(10))
    tm = train_step(tstate, tcfg, LossWeights(), _torch_batch(batch), 10)
    for term in TERMS + ('cost',):
        np.testing.assert_allclose(float(tm[term]), float(jm[term]),
                                   rtol=3e-4, atol=1e-7, err_msg=term)
    want = from_jax_variables(jax.tree_util.tree_map(
        np.asarray, {'params': jstate.params,
                     'constants': jstate.constants}))
    got = tstate.model.state_dict()
    n_stats = 0
    for key, w in want.items():
        if key.endswith(('running_mean', 'running_var')):
            torch.testing.assert_close(got[key], w, rtol=1e-4, atol=1e-5,
                                       msg=lambda m: f'{key}: {m}')
            n_stats += 1
    assert n_stats > 100
    bn_w = tstate.model.backbone._model.Conv3d_1a_7x7.bn.weight
    assert isinstance(bn_w, torch.nn.Parameter)
    torch.testing.assert_close(
        bn_w.detach(), want['backbone._model.Conv3d_1a_7x7.bn.weight'],
        rtol=1e-4, atol=5e-5)
