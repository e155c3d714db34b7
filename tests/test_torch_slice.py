"""The port's inference slice end to end vs the JAX package's, on the CPU.

One synthetic THUMOS-style dataset, one set of seeded port weights saved
as a torch .ckpt. `opental_tpu.tools.test.run_test` loads that .ckpt
through its own converter (convert_bdnet_checkpoint, strict merge: this
pins the port's state_dict key names) and runs its default CLI mode
(packed device ingest + fused device post) in float32;
`opental_torch.tools.test.run_test(device='cpu')` runs the port. The
detection JSONs must agree per proposal, and the JAX package's evaluator
must give equal metrics on both.
"""

import json
import os

import numpy as np
import pytest
import torch

from proposal_matching import assert_proposal_parity

from opental_tpu.config import load_config as jax_load_config
from opental_tpu.eval.detection import DetectionEvaluator
from opental_tpu.tools.test import run_test as jax_run_test
from opental_tpu.utils.synthetic import make_synthetic_dataset

from opental_torch import factory
from opental_torch.config import load_config
from opental_torch.tools.test import run_test

MIN_TOTAL = 100   # matched proposals required of the two test videos


@pytest.fixture(scope='module')
def slice_run(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('slice') / 'synth')
    cfg_path = make_synthetic_dataset(root, clip_length=128, crop_size=32)
    cfg = load_config(cfg_path)
    model = factory.init_weights(
        factory.build_model(cfg, frame_num=128, crop_size=32), seed=0)
    ckpt = os.path.join(root, 'checkpoint-1.ckpt')
    torch.save(model.state_dict(), ckpt)

    common = {'testing.checkpoint_path': ckpt,
              'model.compute_dtype': 'float32'}
    jax_path = jax_run_test(jax_load_config(cfg_path, overrides=dict(
        common, **{'testing.output_json': 'jax.json'})))
    port_path = run_test(load_config(cfg_path, overrides=dict(
        common, **{'testing.output_json': 'port.json'})), device='cpu')
    return root, jax_path, port_path


def test_detection_json_parity(slice_run):
    _, jax_path, port_path = slice_run
    with open(jax_path) as f:
        want = json.load(f)
    with open(port_path) as f:
        got = json.load(f)
    assert set(got) == {'version', 'results', 'external_data'}
    assert_proposal_parity(want, got, min_total=MIN_TOTAL)


def test_evaluator_metrics_equal(slice_run):
    root, jax_path, port_path = slice_run
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
