"""Detection decoding for a batch of sliding windows (on the tensors'
device). Counterpart of `opental_tpu/infer/decode.py`; reference
AFSD/thumos14/test.py:79-140."""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from opental_torch.models.bdnet import dirichlet_expected_prob
from opental_torch.utils import profiling


class DecodedWindows(NamedTuple):
    segments: torch.Tensor                 # (W, P, 2) clip frames in [0, L]
    scores: torch.Tensor                   # (W, P, K) fused class scores
    uncertainty: Optional[torch.Tensor]    # (W, P) mean EDL vacuity
    actionness: Optional[torch.Tensor]     # (W, P) mean sigmoid actionness


def fuse_streams(out: Dict[str, torch.Tensor],
                 flow_out: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """RGB+flow late fusion by head-wise averaging (test.py:91-108)."""
    fused = dict(out)
    for k in ('loc', 'prop_loc', 'conf', 'prop_conf', 'center', 'act',
              'prop_act', 'unct', 'prop_unct'):
        if out.get(k) is not None and flow_out.get(k) is not None:
            fused[k] = (out[k] + flow_out[k]) / 2.0
    return fused


def decode_windows(out: Dict[str, torch.Tensor], clip_length: int,
                   use_edl: bool = False, os_head: bool = False,
                   score_func: str = 'softmax', evidence: str = 'exp',
                   negate_conf: bool = False) -> DecodedWindows:
    """Fuse refined offsets into coarse locs and compose scores
    (test.py:112-140). All shapes (W, P, ...). negate_conf negates the
    class outputs first: GCPL's scores are negative distances. Span
    `decode`."""
    with profiling.span('decode'):
        loc, prop_loc = out['loc'], out['prop_loc']
        conf, prop_conf = out['conf'], out['prop_conf']
        if negate_conf:          # GCPL scores are negative distances (:85-87)
            conf, prop_conf = -conf, -prop_conf
        center = out['center'][..., 0]
        priors = out['priors'][None, :, :1]              # (1, P, 1)

        pre_w = loc[..., :1] + loc[..., 1:]
        loc = 0.5 * pre_w * prop_loc + loc
        segments = torch.cat([priors * clip_length - loc[..., :1],
                              priors * clip_length + loc[..., 1:]], dim=-1)
        segments = torch.clamp(segments, 0.0, clip_length)

        uncertainty = None
        if use_edl:
            uncertainty = (out['unct'] + out['prop_unct']) / 2.0

        actionness = None
        if os_head:
            actionness = (torch.sigmoid(out['act'][..., 0])
                          + torch.sigmoid(out['prop_act'][..., 0])) / 2.0

        if score_func == 'dirichlet':
            conf = dirichlet_expected_prob(conf, evidence)
            prop_conf = dirichlet_expected_prob(prop_conf, evidence)
        else:
            conf = torch.softmax(conf, dim=-1)
            prop_conf = torch.softmax(prop_conf, dim=-1)

        scores = (conf + prop_conf) / 2.0 * torch.sigmoid(center)[..., None]
        if os_head:
            scores = scores * actionness[..., None]
        return DecodedWindows(segments, scores, uncertainty, actionness)
