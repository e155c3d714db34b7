"""The port's mesh inference vs the JAX package's mesh pipeline: the
shared backbone (packed spans, the span axis split over the ranks) and
RGB + flow fusion (packed device ingest, flow one frame short), on the
setup of `test_torch_mesh_inference.py` and at its tolerances.
"""

import pytest

from opental_torch.parallel.dryrun import assert_same_proposals

from test_torch_mesh_inference import mesh_runs
from torch_suite import suite_policy  # noqa: F401 (autouse)

MODES = ('shared', 'fused')


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    return mesh_runs(str(tmp_path_factory.mktemp('mesh_shared')), MODES)


@pytest.mark.parametrize('mode', MODES)
def test_mesh_proposals_match_jax_mesh(runs, mode):
    want, got = runs
    n = assert_same_proposals(want[mode], got[0][mode], mode)
    assert n >= 50, n


@pytest.mark.parametrize('mode', MODES)
def test_ranks_return_the_same_proposals(runs, mode):
    _, got = runs
    assert got[0][mode] == got[1][mode]
