"""Build and load the port's CUDA kernels.

Each `csrc/*.cu` file has a plain C interface and compiles with `nvcc`
into its own shared library, loaded with ctypes. A build happens at
first use, into `opental_torch/_build/<source hash>/` (git-ignored), so
an edited source rebuilds and an unchanged one loads what is there.
`build_all` starts one `nvcc` per source at once (every `csrc/*.cu` by
default) and waits for all.
Nothing here runs when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Iterable, List, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, 'csrc')
BUILD_ROOT = os.path.join(_PKG, '_build')
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']

_LOADED: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}       # source name -> nvcc output
BUILD_SECONDS: Dict[str, float] = {}


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get('CUDA_HOME', ''), 'bin',
                              'nvcc'),
                 '/usr/local/cuda/bin/nvcc', shutil.which('nvcc') or ''):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError('nvcc not found (set CUDA_HOME): the CUDA kernels '
                       'build only where the CUDA toolkit is installed')


def _lib_path(name: str) -> str:
    src = os.path.join(CSRC, name + '.cu')
    with open(src, 'rb') as f:
        digest = hashlib.sha256(f.read() + ' '.join(NVCC_FLAGS).encode()
                                ).hexdigest()[:16]
    return os.path.join(BUILD_ROOT, digest, f'lib{name}.so')


def _start(name: str):
    out = _lib_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f'{out}.{os.getpid()}.tmp'
    cmd = [nvcc_path()] + NVCC_FLAGS + ['-o', tmp,
                                        os.path.join(CSRC, name + '.cu')]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, time.perf_counter()


def sources() -> List[str]:
    """The name of every kernel source, `csrc/<name>.cu`."""
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith('.cu'))


def build_all(names: Optional[Iterable[str]] = None) -> List[str]:
    """Compile every named source (default: all of `csrc/`) that is not
    built yet, all at once. Returns the library paths; raises with nvcc's
    output on failure."""
    names = sources() if names is None else list(names)
    running = {n: _start(n) for n in names}
    for name, job in running.items():
        if job is None:
            continue
        proc, tmp, out, t0 = job
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        BUILD_SECONDS[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed for {name}.cu:\n{log}')
        os.replace(tmp, out)
    return [_lib_path(n) for n in names]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built on first use."""
    lib = _LOADED.get(name)
    if lib is None:
        (path,) = build_all([name])
        lib = ctypes.CDLL(path)
        _LOADED[name] = lib
    return lib
