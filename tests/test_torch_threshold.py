"""The port's THUMOS OOD threshold calibration on the CPU.

* `confidence_score` and `threshold_from_results` equal JAX's on random
  proposal sets, for all six scorings.
* `calibrate` over the synthetic training videos, fused, gives the same
  threshold packed and one video at a time; a THUMOS config given the
  ANet CLI flags still calibrates as THUMOS.

The port's calibration is held against JAX's `calibrate` in
`tests/test_torch_packed_inference.py`, which shares the JAX fused
pipeline with its run_test (one compile of the JAX forward).
"""

import numpy as np
import pytest

from test_torch_packed_inference import PACKING, cli_config, fusion_dataset
from torch_suite import suite_policy  # noqa: F401 (autouse)

from opental_tpu.openset import threshold as jax_threshold

from opental_torch.config import load_config
from opental_torch.openset import threshold
from opental_torch.tools import test as port_test
from opental_torch.tools import threshold as threshold_cli

SCORINGS = ['uncertainty', 'confidence', 'uncertainty_actionness',
            'a_by_inv_u', 'u_by_inv_a', 'half_au']


def random_results(seed, n_videos=7, n_props=23):
    rng = np.random.RandomState(seed)
    return {f'v{v}': [{'score': float(rng.uniform(0, 1)),
                       'uncertainty': float(rng.uniform(0, 1)),
                       'actionness': float(rng.uniform(0, 1))}
                      for _ in range(int(rng.randint(1, n_props)))]
            for v in range(n_videos)}


@pytest.mark.parametrize('scoring', SCORINGS)
@pytest.mark.parametrize('seed', [0, 1])
def test_scores_and_threshold_match_jax(scoring, seed):
    results = random_results(seed)
    for props in results.values():
        for p in props:
            assert threshold.confidence_score(p, scoring) == \
                jax_threshold.confidence_score(p, scoring)
    for tpr in (0.95, 0.5):
        assert threshold.threshold_from_results(results, scoring, tpr) == \
            jax_threshold.threshold_from_results(results, scoring, tpr)


def test_bad_scoring_and_empty_results_raise():
    with pytest.raises(ValueError):
        threshold.confidence_score(
            {'score': 0.5, 'uncertainty': 0.5, 'actionness': 0.5}, 'nope')
    with pytest.raises(ValueError, match='zero proposals'):
        threshold.threshold_from_results({'v': []}, 'confidence')


@pytest.fixture(scope='module')
def cli_cfg(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('threshold') / 'synth')
    cfg_path, fusion = fusion_dataset(root)
    return cli_config(cfg_path, dict(PACKING, **fusion),
                      f'{root}/threshold.yaml')


def test_calibrate_per_video_matches_packed(cli_cfg):
    """`testing.packed: false` runs the first two training videos one at
    a time through the same fused pipeline: the same threshold."""
    thr = {}
    for packed in (True, False):
        cfg = load_config(cli_cfg, overrides={
            'testing.fusion': True, 'testing.packed': packed,
            'testing.output_json': f'thr_packed_{packed}.json'})
        pipe, _, _ = port_test.build_pipeline(cfg, device='cpu')
        assert pipe.flow_model is not None
        thr[packed] = threshold.calibrate(cfg, pipe, max_videos=2)
    np.testing.assert_allclose(thr[False], thr[True], rtol=1e-4)


def test_anet_calibration_is_refused(cli_cfg, monkeypatch):
    """The ANet calibration is refused to a THUMOS config: given
    `--binary` or `--cls_score_file`, the CLI routes on model.arch alone,
    as the JAX CLI does (`opental_tpu/tools/threshold.py:33-40`), and
    calibrates as THUMOS. (ANet configs: tests/test_torch_anet_inference.py.)"""
    calls = []
    monkeypatch.setattr(threshold_cli, 'calibrate_anet',
                        lambda *a, **k: calls.append('anet') or 0.25)
    monkeypatch.setattr(threshold_cli, 'calibrate',
                        lambda *a, **k: calls.append('thumos') or 0.5)
    monkeypatch.setattr(threshold_cli, 'build_pipeline',
                        lambda cfg, device=None: (None, None, None))
    assert load_config(cli_cfg).get_path('model.arch', 'thumos') == 'thumos'
    for i, flags in enumerate((['--binary'], ['--cls_score_file', 'x.json'],
                               ['--binary', '--cls_score_file', 'x.json'])):
        threshold_cli.main([cli_cfg, '--device', 'cpu', *flags,
                            '--output_json', f'routed_{i}.json'])
    assert calls == ['thumos'] * 3
