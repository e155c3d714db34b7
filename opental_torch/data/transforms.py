"""Clip-level spatial transforms (numpy, channels-last (T, H, W, C)).

Counterpart of `opental_tpu/data/transforms.py`; reference
AFSD/common/videotransforms.py.
"""

from __future__ import annotations

import numpy as np


def center_crop(clip: np.ndarray, size: int) -> np.ndarray:
    """Center `size` x `size` crop of a (T, H, W, C) clip (a view)."""
    h, w = clip.shape[1:3]
    i = int(round((h - size) / 2.0))
    j = int(round((w - size) / 2.0))
    return clip[:, i:i + size, j:j + size]
