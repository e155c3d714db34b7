"""What every `tests/test_torch_*.py` file shares: one thread policy and
one JAX compilation cache per test run, set by the autouse fixture
`suite_policy` (import it into the test module:
``from torch_suite import suite_policy  # noqa: F401 (autouse)``).

Thread policy. Under xdist several workers share the host's cores, and
torch sizes its intra-op pool to the whole machine in every worker: the
workers then thrash. Each port test module runs torch on at most
`THREADS` threads; files that spawn rank processes give each rank one
(`opental_torch.parallel.dryrun`). Thread count moves float rounding:
a tolerance is never widened for it.

Compilation cache. Many port files compile the same JAX reference (the
BDNet forward and train step at frame 128 / crop 32 on the same shapes).
From the first port module of a process on, JAX's persistent
compilation cache points at one directory of the run's pytest temporary
directory, which every xdist worker of the run shares and pytest's own
retention removes, so an identical program compiles once per run. The
cache holds what XLA compiled and changes no result.
"""

import os

import pytest
import torch

THREADS = 2
_jax_cache = []      # the cache directory, once this process has one


@pytest.fixture(scope='module', autouse=True)
def suite_policy(tmp_path_factory):
    if not _jax_cache:
        base = tmp_path_factory.getbasetemp()
        if os.environ.get('PYTEST_XDIST_WORKER'):
            base = base.parent          # the workers' common directory
        _jax_cache.append(_enable_jax_compilation_cache(base / 'jax_cache'))
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, THREADS))
    yield
    torch.set_num_threads(n)


def _enable_jax_compilation_cache(path):
    try:
        from jax.experimental.compilation_cache import compilation_cache
    except ImportError:
        return None
    compilation_cache.set_cache_dir(str(path))
    compilation_cache.reset_cache()   # a compile before this one fixed it off
    return path
