"""The port's inference slice end to end vs the JAX package's, on the CPU.

One synthetic THUMOS-style dataset, one set of seeded port weights saved
as a torch .ckpt. `opental_tpu.tools.test.run_test` loads that .ckpt
through its own converter (convert_bdnet_checkpoint, strict merge: this
pins the port's state_dict key names; the flax template from
`jax.eval_shape`, which skips compiling the init) and runs its default
CLI mode
(packed device ingest + fused device post) in float32;
`opental_torch.tools.test.run_test(device='cpu')` runs the port. The
detection JSONs must agree per proposal, and the JAX package's evaluator
must give equal metrics on both. The `_stem_pallas` tests hold the
port's run with `model.stem_pallas: true` (the packed stem, plain pack on
the CPU) on the same dataset and checkpoint against the same JAX JSON:
the JAX package's packed stem computes the same convolution as its
default stem (its tests/test_stem_pack.py holds them together at atol
1e-4), and tests/test_torch_stem_slice.py holds the port's flag-on BDNet
against JAX's flag-on BDNet directly; a second JAX run with the flag (its
Pallas pack in interpret mode) would add ~50 s of CPU to the tier-1 run
and check nothing of the port those do not.
"""

import json
import os

import numpy as np
import pytest
import torch

from proposal_matching import assert_proposal_parity
from test_torch_packed_inference import eval_shape_variables
from torch_suite import suite_policy  # noqa: F401 (autouse)

from opental_tpu.config import load_config as jax_load_config
from opental_tpu.eval.detection import DetectionEvaluator
from opental_tpu.tools import test as jax_test
from opental_tpu.utils.synthetic import make_synthetic_dataset

from opental_torch import factory
from opental_torch.config import load_config
from opental_torch.tools.test import run_test

MIN_TOTAL = 100   # matched proposals required of the two test videos
COMMON = {'model.compute_dtype': 'float32'}


@pytest.fixture(scope='module')
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('slice') / 'synth')
    cfg_path = make_synthetic_dataset(root, clip_length=128, crop_size=32)
    cfg = load_config(cfg_path)
    model = factory.init_weights(
        factory.build_model(cfg, frame_num=128, crop_size=32), seed=0)
    ckpt = os.path.join(root, 'checkpoint-1.ckpt')
    torch.save(model.state_dict(), ckpt)
    return root, cfg_path, ckpt


def port_run(dataset, tag, **overrides):
    root, cfg_path, ckpt = dataset
    return run_test(load_config(cfg_path, overrides=dict(
        COMMON, **{'testing.checkpoint_path': ckpt,
                   'testing.output_json': f'port{tag}.json'}, **overrides)),
        device='cpu')


@pytest.fixture(scope='module')
def slice_run(dataset):
    """(root, JAX JSON path, port JSON path)."""
    root, cfg_path, ckpt = dataset
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_test, 'load_variables', eval_shape_variables)
        jax_path = jax_test.run_test(jax_load_config(cfg_path, overrides=dict(
            COMMON, **{'testing.checkpoint_path': ckpt,
                       'testing.output_json': 'jax.json'})))
    return root, jax_path, port_run(dataset, '')


@pytest.fixture(scope='module')
def slice_run_stem_pallas(dataset, slice_run):
    root, jax_path, _ = slice_run
    return root, jax_path, port_run(dataset, '_stem_pallas',
                                    **{'model.stem_pallas': True})


def check_json_parity(run):
    _, jax_path, port_path = run
    with open(jax_path) as f:
        want = json.load(f)
    with open(port_path) as f:
        got = json.load(f)
    assert set(got) == {'version', 'results', 'external_data'}
    assert_proposal_parity(want, got, min_total=MIN_TOTAL)


def test_detection_json_parity(slice_run):
    check_json_parity(slice_run)


def test_detection_json_parity_stem_pallas(slice_run_stem_pallas):
    check_json_parity(slice_run_stem_pallas)


def check_metrics_equal(run):
    root, jax_path, port_path = run
    anno = os.path.join(root, 'annotations')

    def metrics(pred):
        ev = DetectionEvaluator(
            os.path.join(anno, 'gt_open.json'), pred,
            os.path.join(anno, 'Class_Index_Known.txt'),
            tiou_thresholds=np.array([0.3, 0.5, 0.7]),
            ood_scoring='uncertainty', subset=['test'], openset=True)
        mAP, _, _ = ev.evaluate('AP')
        ev.pre_evaluate()
        auc = ev.evaluate('AUC')
        osdr = ev.evaluate('OSDR')
        return np.concatenate([np.atleast_1d(np.asarray(x, np.float64))
                               for x in (mAP, *auc, osdr)])

    np.testing.assert_allclose(metrics(port_path), metrics(jax_path),
                               atol=1e-6)


def test_evaluator_metrics_equal(slice_run):
    check_metrics_equal(slice_run)


def test_evaluator_metrics_equal_stem_pallas(slice_run_stem_pallas):
    check_metrics_equal(slice_run_stem_pallas)
