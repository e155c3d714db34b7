"""ctypes binding of the native libmr Weibull meta-recognition library.

Counterpart of `opental_tpu/openset/libmr.py`; its Python API mirrors the
reference Cython wrapper (experiments/openmax/libMR/libmr.pyx:95-256):
MR().fit_high(data, k), w_score(x), w_score_vector(xs), cdf / inv, and
JSON (de)serialization in place of the reference's string format.

The library is host code. At first use it is compiled from the
repository's `native/libmr/libmr.cpp` with `g++` and the flags of that
directory's Makefile into `opental_torch/_build/libmr-<source hash>/`
(git-ignored); nothing under `native/` is written. Concurrent builds
(parallel test workers) each write a temporary file and rename it into
place.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import shutil
import subprocess
from typing import Optional, Sequence

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG), 'native', 'libmr', 'libmr.cpp')
BUILD_ROOT = os.path.join(_PKG, '_build')
CXX_FLAGS = ['-O2', '-fPIC', '-std=c++17', '-shared']
_lib: Optional[ctypes.CDLL] = None


def library_path() -> str:
    """Where the library of the current source and flags is built."""
    with open(SOURCE, 'rb') as f:
        digest = hashlib.sha256(f.read() + ' '.join(CXX_FLAGS).encode()
                                ).hexdigest()[:16]
    return os.path.join(BUILD_ROOT, f'libmr-{digest}', 'libmr.so')


def build() -> str:
    """Compile the library unless it is there; returns its path."""
    out = library_path()
    if os.path.exists(out):
        return out
    cxx = os.environ.get('CXX') or shutil.which('g++') or 'g++'
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f'{out}.{os.getpid()}.tmp'
    proc = subprocess.run([cxx] + CXX_FLAGS + ['-o', tmp, SOURCE],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'{cxx} failed for {SOURCE}:\n{proc.stderr}')
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build())
    dp = ctypes.POINTER(ctypes.c_double)
    lib.mr_fit_high.restype = ctypes.c_int
    lib.mr_fit_high.argtypes = [dp, ctypes.c_int, ctypes.c_int,
                                ctypes.c_double, dp, dp, dp]
    lib.mr_w_score.restype = ctypes.c_double
    lib.mr_w_score.argtypes = [ctypes.c_double, ctypes.c_double,
                               ctypes.c_double, ctypes.c_double,
                               ctypes.c_double, ctypes.c_int]
    lib.mr_w_score_vector.restype = None
    lib.mr_w_score_vector.argtypes = [dp, ctypes.c_int, ctypes.c_double,
                                      ctypes.c_double, ctypes.c_double,
                                      ctypes.c_double, ctypes.c_int, dp]
    lib.mr_weibull_inv.restype = ctypes.c_double
    lib.mr_weibull_inv.argtypes = [ctypes.c_double, ctypes.c_double,
                                   ctypes.c_double]
    _lib = lib
    return lib


def _as_double_ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


class MR:
    """Weibull tail model (the reference MR class)."""

    def __init__(self, fitting_size: int = 9,
                 translate_amount: float = 10000.0):
        self.fitting_size = fitting_size
        self.translate_amount = translate_amount
        self.scale = 0.0
        self.shape = 0.0
        self.small_score = 0.0
        self.sign = 1
        self.is_valid = False

    def fit_high(self, data: Sequence[float], fit_size: int = 0) -> bool:
        """Weibull-fit the top tail (MetaRecognition::FitHigh)."""
        lib = _load()
        if fit_size > 0:
            self.fitting_size = fit_size
        arr = np.ascontiguousarray(data, dtype=np.float64)
        scale, shape, small = (ctypes.c_double() for _ in range(3))
        rval = lib.mr_fit_high(_as_double_ptr(arr), len(arr),
                               self.fitting_size, self.translate_amount,
                               ctypes.byref(scale), ctypes.byref(shape),
                               ctypes.byref(small))
        self.sign = 1
        self.is_valid = rval == 1
        if self.is_valid:
            self.scale, self.shape = scale.value, shape.value
            self.small_score = small.value
        return self.is_valid

    def w_score(self, x: float) -> float:
        if not self.is_valid:
            return -9999.0
        return _load().mr_w_score(float(x), self.scale, self.shape,
                                  self.translate_amount, self.small_score,
                                  self.sign)

    def w_score_vector(self, xs: Sequence[float]) -> np.ndarray:
        arr = np.ascontiguousarray(xs, dtype=np.float64)
        if not self.is_valid:
            # a degenerate fit (e.g. a tail too small): no rejection mass
            return np.zeros_like(arr)
        out = np.empty_like(arr)
        _load().mr_w_score_vector(_as_double_ptr(arr), len(arr), self.scale,
                                  self.shape, self.translate_amount,
                                  self.small_score, self.sign,
                                  _as_double_ptr(out))
        return out

    def cdf(self, x: float) -> float:
        return self.w_score(x)

    def inv(self, p: float) -> float:
        if not self.is_valid:
            return -9999.0
        score = _load().mr_weibull_inv(float(p), self.scale, self.shape)
        return (score - self.translate_amount + self.small_score) \
            * self.sign

    # -------- persistence (JSON in place of the reference's str format)
    def to_dict(self) -> dict:
        return {'scale': self.scale, 'shape': self.shape,
                'small_score': self.small_score, 'sign': self.sign,
                'translate_amount': self.translate_amount,
                'fitting_size': self.fitting_size,
                'is_valid': self.is_valid}

    @classmethod
    def from_dict(cls, d: dict) -> 'MR':
        mr = cls(fitting_size=d.get('fitting_size', 9),
                 translate_amount=d.get('translate_amount', 10000.0))
        mr.scale = d['scale']
        mr.shape = d['shape']
        mr.small_score = d['small_score']
        mr.sign = d.get('sign', 1)
        mr.is_valid = d.get('is_valid', True)
        return mr

    def save(self, path: str) -> None:
        with open(path, 'w') as f:
            json.dump(self.to_dict(), f)

    @classmethod
    def load(cls, path: str) -> 'MR':
        with open(path) as f:
            return cls.from_dict(json.load(f))
