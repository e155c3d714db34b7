"""Clip-level spatial transforms (numpy, channels-last (T, H, W, C)).

Counterpart of `opental_tpu/data/transforms.py`; reference
AFSD/common/videotransforms.py. The random transforms draw from a
`random.Random` with the JAX package's calls in its order, so a seed gives
the same crops and flips in both packages.
"""

from __future__ import annotations

import random
from typing import Tuple

import numpy as np


def _crop_box(h: int, w: int, th: int, tw: int,
              rng: random.Random) -> Tuple[int, int]:
    if w == tw and h == th:
        return 0, 0
    return rng.randint(0, h - th), rng.randint(0, w - tw)


def random_crop(clip: np.ndarray, size: int,
                rng: random.Random) -> np.ndarray:
    """Random `size` x `size` crop of a (T, H, W, C) clip (a view)."""
    h, w = clip.shape[1:3]
    i, j = _crop_box(h, w, size, size, rng)
    return clip[:, i:i + size, j:j + size]


def center_crop(clip: np.ndarray, size: int) -> np.ndarray:
    """Center `size` x `size` crop of a (T, H, W, C) clip (a view)."""
    h, w = clip.shape[1:3]
    i = int(round((h - size) / 2.0))
    j = int(round((w - size) / 2.0))
    return clip[:, i:i + size, j:j + size]


def random_hflip(clip: np.ndarray, rng: random.Random,
                 p: float = 0.5) -> np.ndarray:
    """Mirror the width axis with probability p (a view)."""
    if rng.random() < p:
        return clip[:, :, ::-1]
    return clip


def normalize_clip(clip: np.ndarray) -> np.ndarray:
    """uint8 [0, 255] -> float32 [-1, 1] (thumos_dataset.py:263)."""
    return (clip.astype(np.float32) / 255.0) * 2.0 - 1.0
