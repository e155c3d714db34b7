"""THUMOS14 annotation parsing needed by inference.

Counterpart of `opental_tpu/data/thumos.py` (reference
AFSD/common/thumos_dataset.py:13-33).
"""

from __future__ import annotations

import csv
from typing import Dict, Tuple


def get_class_index_map(class_info_path: str
                        ) -> Tuple[Dict[int, int], Dict[int, str]]:
    """Class_Index file -> (origin idx -> contiguous idx starting at 1,
    contiguous idx -> name)."""
    originidx_to_idx: Dict[int, int] = {}
    idx_to_class: Dict[int, str] = {}
    with open(class_info_path) as f:
        rows = [ln.split() for ln in f.read().splitlines() if ln.strip()]
    for i, (origin, name) in enumerate(rows):
        originidx_to_idx[int(origin)] = i + 1
        idx_to_class[i + 1] = name
    return originidx_to_idx, idx_to_class


def get_video_info(video_info_path: str) -> Dict[str, Dict[str, float]]:
    """video_info CSV -> {video: {fps, sample_fps, count, sample_count}}."""
    infos: Dict[str, Dict[str, float]] = {}
    with open(video_info_path) as f:
        for row in csv.DictReader(f):
            vals = list(row.values())
            infos[vals[0]] = {
                'fps': float(vals[1]),
                'sample_fps': float(vals[2]),
                'count': float(vals[3]),
                'sample_count': int(float(vals[4])),
            }
    return infos
