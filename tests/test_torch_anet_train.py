"""The port's ActivityNet train step vs the JAX package's, on the CPU in
float32 (the port's ANet training loop end to end:
`test_torch_anet_train_loop.py`).

From one set of flax variables (the ANet BDNet's init shapes at frame
256, crop 32, seeded numpy values) carried over with
`from_jax_variables`, both packages take 3 steps of the dual-LR Adam
(the backbone at 0.1 x the heads' rate of 1e-5, the rate of the THUMOS
k-step test: Adam moves a parameter whose gradient is float noise by
about the rate, whatever the noise) on the same uint8 batches of the
synthetic ANet dataset (bs 2, padded clips with their pad masks) at
epochs 9, 10 and 11, which crosses the exp-form MIB gate (ibm_start 10).
Held: each step's cost at rtol 1e-4, each loss term and the global
gradient norm at rtol 3e-4, and the final parameters at rtol 1e-4 / atol
5e-5, the k-step tolerances of `test_torch_train_step.py`.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from opental_tpu.losses.edl import EDLConfig as JEDLConfig
from opental_tpu.losses.multisegment import LossConfig as JLossConfig
from opental_tpu.models.bdnet import BDNet as JBDNet
from opental_tpu.train.step import (LossWeights as JLossWeights,
                                    TrainState as JTrainState,
                                    make_anet_optimizer as jmake_optimizer,
                                    make_train_step)

from opental_torch.config import load_config
from opental_torch.data.anet import AnetTrainDataset
from opental_torch.losses.edl import EDLConfig
from opental_torch.losses.multisegment import LossConfig
from opental_torch.models.bdnet import BDNet
from opental_torch.train.step import (LossWeights, TrainState,
                                      make_anet_optimizer, train_step)
from opental_torch.utils.convert import from_jax_variables
from opental_torch.utils.synthetic import make_synthetic_anet_dataset

from test_torch_anet_model import numpy_variables
from torch_suite import suite_policy  # noqa: F401 (autouse)

FRAME, CROP, CLASSES = 256, 32, 5
LR, WD = 1e-5, 1e-4
EPOCHS = (9, 10, 11)
TERMS = ('loss_l', 'loss_c', 'loss_prop_l', 'loss_prop_c', 'loss_ct',
         'loss_act', 'loss_prop_act', 'loss_start', 'loss_end', 'loss_trip')
EDL = dict(num_classes=CLASSES - 1, loss_type='log', evidence='exp',
           iou_aware=True, with_ibm=True, ibm_exp=True, ibm_coeff=10.0,
           ibm_start=10)
LOSS = dict(num_classes=CLASSES - 1, clip_length=FRAME, piou=0.0,
            cls_type='edl', os_head=True, act_margin=1.0, act_weight=0.1,
            variant='anet')


@pytest.fixture(scope='module')
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('anet_train') / 'synth')
    return make_synthetic_anet_dataset(root, n_train=6, n_val=1,
                                       clip_length=FRAME, crop_size=CROP)


@pytest.fixture(scope='module')
def three_steps(dataset):
    cfg = load_config(dataset)
    ds = AnetTrainDataset(cfg.get_path('dataset.training.video_info_path'),
                          cfg.get_path('dataset.training.video_data_path'),
                          clip_length=FRAME, crop_size=CROP, seed=1,
                          uint8_ingest=True)
    batches = list(ds.batches(2))[:len(EPOCHS)]
    assert len(batches) == len(EPOCHS)
    assert any(b['pad_masks'].any() for b in batches)

    jm = JBDNet(num_classes=CLASSES, os_head=True, use_edl=True,
                frame_num=FRAME, arch='anet', deterministic=False)
    v = numpy_variables(dict(jax.eval_shape(
        jm.init, jax.random.PRNGKey(0),
        jnp.zeros((1, FRAME, CROP, CROP, 3), jnp.float32))))
    tx = jmake_optimizer(LR, WD)
    jstate = JTrainState(params=v['params'], constants=v['constants'],
                         opt_state=tx.init(v['params']), edl_state=None)
    jstep = jax.jit(make_train_step(
        jm, JLossConfig(edl=JEDLConfig(**EDL), **LOSS), JLossWeights(), tx))

    tm = BDNet(num_classes=CLASSES, os_head=True, use_edl=True,
               frame_num=FRAME, crop_size=CROP, arch='anet')
    tm.load_state_dict(from_jax_variables(v), strict=True)
    tstate = TrainState(model=tm, optimizer=make_anet_optimizer(tm, LR, WD))
    tcfg = LossConfig(edl=EDLConfig(**EDL), **LOSS)
    rows = []
    for batch, epoch in zip(batches, EPOCHS):
        jstate, jmet = jstep(jstate, {k: jnp.asarray(x)
                                      for k, x in batch.items()},
                             jnp.asarray(epoch))
        tmet = train_step(tstate, tcfg, LossWeights(),
                          {k: torch.from_numpy(x) for k, x in batch.items()},
                          epoch)
        rows.append(({k: float(x) for k, x in jmet.items()},
                     {k: float(x) for k, x in tmet.items()}))
    return jstate, tstate, rows


def test_costs_and_terms_match_jax(three_steps):
    _, _, rows = three_steps
    for step, (jm, tm) in enumerate(rows):
        np.testing.assert_allclose(tm['cost'], jm['cost'], rtol=1e-4,
                                   err_msg=f'step {step}')
        np.testing.assert_allclose(tm['grad_norm'], jm['grad_norm'],
                                   rtol=3e-4, err_msg=f'step {step}')
        for k in TERMS:
            np.testing.assert_allclose(tm[k], jm[k], rtol=3e-4, atol=1e-6,
                                       err_msg=f'step {step} {k}')
    assert any(r[0]['loss_trip'] > 0 for r in rows)


def test_parameters_match_jax(three_steps):
    jstate, tstate, _ = three_steps
    want = from_jax_variables({'params': jax.tree_util.tree_map(
        np.asarray, jstate.params), 'constants': jstate.constants})
    got = tstate.model.state_dict()
    for k, w in want.items():
        torch.testing.assert_close(got[k], w, rtol=1e-4, atol=5e-5,
                                   msg=lambda m: f'{k}: {m}')
