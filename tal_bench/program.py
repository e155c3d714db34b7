"""What the benchmark takes from the program (`opental_torch`): its
configuration loader, and the pieces the runners drive. Nothing else of
the benchmark imports the program, and the reference never does."""

from __future__ import annotations

import os
import tempfile
from typing import Any, Dict, Optional

import yaml


def load_config(config: Dict[str, Any],
                overrides: Optional[Dict[str, Any]] = None):
    """The program's Config of a configuration's dict, read by the
    program's own loader (as the CLIs read a YAML file)."""
    from opental_torch.config import load_config as program_load
    fd, path = tempfile.mkstemp(suffix='.yaml')
    try:
        with os.fdopen(fd, 'w') as f:
            yaml.safe_dump(config, f)
        return program_load(path, overrides=overrides)
    finally:
        os.remove(path)


def merged(config: Dict[str, Any], overrides: Dict[str, Any]
           ) -> Dict[str, Any]:
    """A copy of the plain dict with dotted overrides applied (what the
    reference reads)."""
    import copy
    out = copy.deepcopy(config)
    for dotted, value in overrides.items():
        cur = out
        parts = dotted.split('.')
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = value
    return out
