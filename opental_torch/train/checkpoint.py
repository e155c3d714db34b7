"""Checkpoint save and resume.

Counterpart of `opental_tpu/train/checkpoint.py` (reference
AFSD/thumos14/train.py:97-131). One file per epoch,
`<checkpoint_path>/checkpoint-<epoch>.ckpt`, holds the model's state_dict
under 'model', the optimizer, the EDL bin state, the epoch, the step
count and the generator states; `checkpoint-latest.ckpt` is a symlink to
the newest. `opental_torch.tools.test.load_variables` reads the model
weights of such a file.
"""

from __future__ import annotations

import os
import random
from typing import Any, Dict, Optional

import torch

from opental_torch.losses.edl import EDLState
from opental_torch.train.step import TrainState

LATEST = 'checkpoint-latest.ckpt'


def epoch_path(checkpoint_path: str, epoch: int) -> str:
    return os.path.join(os.path.abspath(checkpoint_path),
                        f'checkpoint-{epoch}.ckpt')


def generator_states(data_rng: Optional[random.Random] = None
                     ) -> Dict[str, Any]:
    """The data order's Python generator, torch's CPU generator (dropout
    on the CPU) and, where there is a card, its generators."""
    states: Dict[str, Any] = {'torch': torch.get_rng_state()}
    if data_rng is not None:
        states['data'] = data_rng.getstate()
    if torch.cuda.is_available():
        states['cuda'] = torch.cuda.get_rng_state_all()
    return states


def set_generator_states(states: Dict[str, Any],
                         data_rng: Optional[random.Random] = None) -> None:
    torch.set_rng_state(states['torch'])
    if data_rng is not None and 'data' in states:
        data_rng.setstate(states['data'])
    if 'cuda' in states and torch.cuda.is_available():
        torch.cuda.set_rng_state_all(states['cuda'])


def save(checkpoint_path: str, epoch: int, state: TrainState,
         data_rng: Optional[random.Random] = None) -> str:
    """Write the train state after `epoch` and point the latest link at
    it. The file is written whole, then moved into place."""
    os.makedirs(checkpoint_path, exist_ok=True)
    path = epoch_path(checkpoint_path, epoch)
    edl = state.edl_state
    payload = {
        'model': state.model.state_dict(),
        'optimizer': state.optimizer.state_dict(),
        'edl_state': None if edl is None else edl._asdict(),
        'epoch': epoch,
        'step': state.step,
        'generators': generator_states(data_rng),
    }
    tmp = f'{path}.{os.getpid()}.tmp'
    torch.save(payload, tmp)
    os.replace(tmp, path)
    link = os.path.join(os.path.abspath(checkpoint_path), LATEST)
    if os.path.lexists(link):
        os.remove(link)
    os.symlink(os.path.basename(path), link)
    return path


def restore(checkpoint_path: str, epoch: Optional[int], state: TrainState,
            data_rng: Optional[random.Random] = None) -> int:
    """Load the checkpoint of `epoch` (the latest if None) into `state` in
    place, and the generator states. Returns the checkpoint's epoch."""
    path = (epoch_path(checkpoint_path, epoch) if epoch is not None
            else os.path.realpath(os.path.join(checkpoint_path, LATEST)))
    device = next(state.model.parameters()).device
    payload = torch.load(path, map_location='cpu', weights_only=True)
    state.model.load_state_dict(payload['model'], strict=True)
    state.optimizer.load_state_dict(payload['optimizer'])
    if payload['edl_state'] is not None:
        state.edl_state = EDLState(**payload['edl_state']).to(device)
    state.step = int(payload['step'])
    set_generator_states(payload['generators'], data_rng)
    return int(payload['epoch'])


def latest_epoch(checkpoint_path: str) -> Optional[int]:
    """Epoch of the file the latest link points at, or None when there is
    no link."""
    link = os.path.join(os.path.abspath(checkpoint_path), LATEST)
    if not os.path.lexists(link):
        return None
    name = os.path.basename(os.path.realpath(link))
    return int(name[len('checkpoint-'):-len('.ckpt')])
