"""Carry the JAX package's variables into the port.

`from_jax_variables` takes the flax tree `{'params': ..., 'constants':
...}` of `opental_tpu.models.bdnet.BDNet` (as numpy or jax arrays, e.g.
restored from an orbax checkpoint where JAX is installed) and returns the
port BDNet's state_dict: the inverse of the JAX package's
`utils/torch_convert.map_bdnet_key`. Layouts:

  conv3d (kT, kH, kW, I, O) -> (O, I, kT, kH, kW)
  conv1d (k, I, O)          -> (O, I, k)
  BN scale/bias/mean/var    -> weight/bias/running_mean/running_var
  GN scale/bias             -> weight/bias

It is strict: a JAX leaf that maps to no port key, or two leaves that
map to one key, raise here; loading the result with
`load_state_dict(..., strict=True)` raises for a port parameter or
buffer left unfilled.
"""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

_CONV = {'kernel': 'weight', 'bias': 'bias'}
_AFFINE = {'scale': 'weight', 'bias': 'bias'}
_BN = {'scale': 'weight', 'bias': 'bias', 'mean': 'running_mean',
       'var': 'running_var'}
_XFORMS = {
    'conv3d': lambda w: np.transpose(w, (4, 3, 0, 1, 2)),
    'conv1d': lambda w: np.transpose(w, (2, 1, 0)),
    None: lambda w: w,
}

Entry = Tuple[str, Optional[str]]


def _conv(prefix: str, kind: str, leaf: str) -> Entry:
    return (f'{prefix}.{kind}.{_CONV[leaf]}',
            kind if leaf == 'kernel' else None)


def _block(base: str, tail: Tuple[str, ...], conv_slot: int = 0,
           gn_slot: int = 1) -> Entry:
    """A ConvGNReLU1D: (conv, conv, leaf) or (gn, leaf) under `base`."""
    if tail[:2] == ('conv', 'conv') and len(tail) == 3:
        return _conv(f'{base}.{conv_slot}', 'conv1d', tail[2])
    if tail[0] == 'gn' and len(tail) == 2:
        return f'{base}.{gn_slot}.{_AFFINE[tail[1]]}', None
    raise KeyError(tail)


def _pyramid_key(rest: Tuple[str, ...]) -> Entry:
    p = 'coarse_pyramid_detection.'
    name = rest[0]
    m = re.fullmatch(r'pyramid_(\d)_(conv|gn)', name)
    if m:
        i, part = m.groups()
        if part == 'conv' and rest[1] == 'conv' and len(rest) == 3:
            return _conv(f'{p}pyramids.{i}.0', 'conv3d', rest[2])
        if part == 'gn' and len(rest) == 2:
            return f'{p}pyramids.{i}.1.{_AFFINE[rest[1]]}', None
        raise KeyError(rest)
    m = re.fullmatch(r'pyramid_(\d)', name)
    if m:
        return _block(f'{p}pyramids.{m.group(1)}', rest[1:])
    if name in ('loc_tower', 'conf_tower'):
        blk = re.fullmatch(r'block_(\d)', rest[1]).group(1)
        return _block(f'{p}{name}.{blk}', rest[2:])
    m = re.fullmatch(r'deconv_(\d)', name)
    if m:
        j = int(m.group(1))
        return _block(f'{p}deconv', rest[1:], 3 * j, 3 * j + 1)
    if name in ('loc_proposal_branch', 'conf_proposal_branch'):
        return _block(f'{p}{name}.{rest[1]}', rest[2:])
    m = re.fullmatch(r'loc_scale_(\d)', name)
    if m and rest[1:] == ('scale',):
        return f'{p}loc_heads.{m.group(1)}.scale', None
    if rest[1] == 'conv' and len(rest) == 3:
        return _conv(f'{p}{name}', 'conv1d', rest[2])
    raise KeyError(rest)


def map_jax_path(path: Tuple[str, ...]) -> Entry:
    """JAX variable path (without the collection) -> (port state_dict
    key, layout transform). Raises KeyError for a path the port lacks."""
    try:
        if path[0] == 'backbone':
            *mods, mod, leaf = path[1:]
            prefix = 'backbone._model.' + '.'.join(mods)
            if mod == 'conv':
                return _conv(prefix, 'conv3d', leaf)
            if mod == 'bn':
                return f'{prefix}.bn.{_BN[leaf]}', None
        elif path[0] == 'pyramid':
            return _pyramid_key(tuple(path[1:]))
    except (KeyError, IndexError, AttributeError):
        pass
    raise KeyError(f'no port key for JAX variable {"/".join(path)}')


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def from_jax_variables(variables: Mapping[str, Any]
                       ) -> Dict[str, torch.Tensor]:
    """{'params', 'constants'} flax tree -> port BDNet state_dict."""
    out: Dict[str, torch.Tensor] = OrderedDict()
    for col, tree in variables.items():
        for path, leaf in _leaves(tree):
            key, xf = map_jax_path(path)
            if key in out:
                raise KeyError(f'{key} filled twice ({col}/'
                               f'{"/".join(path)})')
            arr = _XFORMS[xf](np.asarray(leaf, np.float32))
            out[key] = torch.from_numpy(np.array(arr, order='C'))
    return out
