"""OpenTAL in PyTorch for NVIDIA Hopper (H100).

A port of `opental_tpu` (JAX) that imports nothing of it. The main path
is THUMOS14 open-set inference (`python -m opental_torch.tools.test
<cfg.yaml>`), with the boundary max-pool forward as a hand-written CUDA
kernel (`csrc/boundary_pool.cu`). Entry points run on the card unless
the caller asks for the CPU.
"""

from __future__ import annotations

from typing import Optional, Union


def resolve_device(device: Optional[Union[str, 'torch.device']] = None
                   ) -> 'torch.device':
    """`device` or, when None, the card. Raises if the card is asked
    for and there is none: the entry points never carry on on the CPU
    unless the caller asks for it. (torch is imported here, not with the
    package: the host-only tools and their worker processes do not need
    it.)"""
    import torch
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'no CUDA device is available; pass device="cpu" to run on '
            'the CPU')
    return dev
