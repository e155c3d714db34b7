"""Seeded weights for a model the benchmark hands to the program.

Real I3D / OpenTAL weights are not in the repository, so every cell
runs seeded random weights. They are drawn on the model's device in two
large calls (one uniform, one normal draw over every element), then
sliced into the tensors, in the distributions of the port's
`factory.init_weights` (inference: glorot-uniform convolutions, BN and
GroupNorm perturbed; the head biases are this module's own, below) or `factory.init_train_weights`
(training: glorot-uniform convolutions, zero biases, norms at their
defaults; ActivityNet's tower and head convolutions normal(0, 0.01)).
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch
from torch import nn

from tal_bench.traffic import generator

# inference head biases (mean, std): actionness and centreness well
# above their gates and class evidence spread little, so that every
# class of every prior scores above the 0.01 threshold on any seed and
# soft-NMS takes each class's whole preselect (the port's init spreads
# them by 2, and the work then changes 500-fold from seed to seed)
ACT_BIAS = (4.0, 0.25)
CENTER_BIAS = (2.0, 0.25)
CLASS_BIAS = (0.0, 0.5)
ANET_REINIT = ('loc_tower', 'conf_tower', 'loc_head', 'conf_head',
               'loc_proposal_branch', 'conf_proposal_branch',
               'prop_loc_head', 'prop_conf_head', 'center_head')


def _targets(model: nn.Module, style: str, arch: str
             ) -> List[Tuple[torch.Tensor, str, Tuple[float, ...]]]:
    """(tensor, draw, args): draw 'u' fills lo + (hi - lo) * U, 'n'
    mean + std * N, 'c' a constant."""
    out = []
    infer = style == 'infer'
    for name, mod in model.named_modules():
        if isinstance(mod, (nn.Conv1d, nn.Conv3d, nn.Linear)):
            w = mod.weight
            top = name.split('.')[1] if name.startswith(
                'coarse_pyramid_detection.') else ''
            if not infer and arch == 'anet' and isinstance(mod, nn.Conv1d) \
                    and top in ANET_REINIT:
                out.append((w, 'n', (0.0, 0.01)))
            else:
                rf = math.prod(w.shape[2:])
                lim = math.sqrt(6.0 / ((w.shape[0] + w.shape[1]) * rf))
                out.append((w, 'u', (-lim, lim)))
            if mod.bias is None:
                continue
            if not infer:
                out.append((mod.bias, 'c', (0.0,)))
            elif name.endswith('actionness_head.conv1d'):
                out.append((mod.bias, 'n', ACT_BIAS))
            elif name.endswith('center_head.conv1d'):
                out.append((mod.bias, 'n', CENTER_BIAS))
            elif name.endswith('conf_head.conv1d'):
                out.append((mod.bias, 'n', CLASS_BIAS))
            else:
                out.append((mod.bias, 'n', (0.0, 0.1)))
        elif infer and hasattr(mod, 'running_var') and \
                hasattr(mod, 'running_mean'):
            out += [(mod.weight, 'n', (1.0, 0.1)), (mod.bias, 'n', (0.0, 0.1)),
                    (mod.running_mean, 'n', (0.0, 0.2)),
                    (mod.running_var, 'u', (0.8, 1.2))]
        elif infer and isinstance(mod, nn.GroupNorm):
            out += [(mod.weight, 'n', (1.0, 0.1)), (mod.bias, 'n', (0.0, 0.1))]
    return out


@torch.no_grad()
def seed_weights(model: nn.Module, seed: int, style: str) -> nn.Module:
    """Fill `model` in place from the seed ('infer' or 'train' style)
    on the device its parameters are on."""
    targets = _targets(model, style, getattr(model, 'arch', 'thumos'))
    device = next(model.parameters()).device
    sizes = {d: sum(t.numel() for t, dd, _ in targets if dd == d)
             for d in 'un'}
    pool = {'u': torch.rand(sizes['u'], generator=generator(
                seed, 'weights_u', device), device=device),
            'n': torch.randn(sizes['n'], generator=generator(
                seed, 'weights_n', device), device=device)}
    at = {'u': 0, 'n': 0}
    for t, draw, args in targets:
        if draw == 'c':
            t.fill_(args[0])
            continue
        flat = pool[draw][at[draw]:at[draw] + t.numel()].view(t.shape)
        at[draw] += t.numel()
        if draw == 'u':
            lo, hi = args
            t.copy_(lo + (hi - lo) * flat)
        else:
            mean, std = args
            t.copy_(mean + std * flat)
    return model
