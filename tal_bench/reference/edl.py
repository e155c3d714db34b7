"""Evidential Deep Learning classification losses.

Counterpart of `opental_tpu/losses/edl.py:34-243` (reference EvidenceLoss,
AFSD/thumos14/cls_loss.py:81-285). Rows are fixed-shape (N, K) logits
with a boolean `valid` mask. The GHM / MIB bin accumulators (the
reference's acc_sum / weight_accum buffers) are an explicit `EDLState` of
tensors on the logits' device, passed in and returned:
`(loss, new_state) = evidence_loss(..., state, epoch)`. The epoch gates
(ghm_start, ib_start, ibm_start) read a Python int epoch.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple, Union

import torch
import torch.nn.functional as F

EPS = 1e-10


class EDLConfig(NamedTuple):
    """Static EDL loss configuration (training.edl_config in YAML)."""
    num_classes: int
    loss_type: str = 'log'           # 'log' | 'digamma' | 'mse'
    evidence: str = 'exp'
    with_focal: bool = False
    alpha: float = 0.25
    gamma: float = 2.0
    soft_label: float = 0.0
    iou_aware: bool = False
    with_ghm: bool = False
    with_ibloss: bool = False
    with_ibm: bool = False
    # ANet's exp-form MIB, stateless (anet/cls_loss.py:225-231); False is
    # the THUMOS binned-EMA MIB
    ibm_exp: bool = False
    ibm_coeff: float = 10.0
    num_bins: int = 50
    momentum: float = 0.99
    ghm_start: int = 0
    ib_start: int = 10
    ibm_start: int = 0
    size_average: bool = False


class EDLState(NamedTuple):
    """Cross-step EMA accumulators (MIB weight_accum / GHM acc_sum), each
    a (num_bins,) float32 tensor."""
    weight_accum: torch.Tensor
    acc_sum: torch.Tensor

    @staticmethod
    def create(cfg: EDLConfig, device: Union[str, torch.device] = 'cpu'
               ) -> 'EDLState':
        return EDLState(
            weight_accum=torch.ones(cfg.num_bins, device=device),
            acc_sum=torch.zeros(cfg.num_bins, device=device))

    def to(self, device: Union[str, torch.device]) -> 'EDLState':
        return EDLState(*(t.to(device) for t in self))


def evidence_func(logit: torch.Tensor, evidence: str) -> torch.Tensor:
    if evidence == 'relu':
        return torch.relu(logit)
    if evidence == 'exp':
        return torch.exp(torch.clamp(logit, -10.0, 10.0))
    if evidence == 'softplus':
        return F.softplus(logit)
    raise ValueError(evidence)


def _one_hot_soft(target: torch.Tensor, num_classes: int,
                  soft_label: float) -> torch.Tensor:
    y = F.one_hot(target.long(), num_classes).float()
    if soft_label > 0:
        y = torch.where(y == 1.0, torch.full_like(y, 1.0 - soft_label),
                        torch.full_like(y, soft_label / (num_classes - 1)))
    return y


def _edl_base(y: torch.Tensor, alpha: torch.Tensor, loss_type: str
              ) -> torch.Tensor:
    """Per-element y * (f(S) - f(alpha)), f = log or digamma. (N, K)."""
    s = alpha.sum(dim=1, keepdim=True)
    f = torch.log if loss_type == 'log' else torch.digamma
    return y * (f(s) - f(alpha))


def _grad_norm_terms(y: torch.Tensor, alpha: torch.Tensor,
                     num_classes: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Detached |y * (1/alpha - u)| terms of the GHM / IB / MIB weights."""
    alpha = alpha.detach()
    u = num_classes / alpha.sum(dim=-1, keepdim=True)
    per_elem = (1.0 / alpha - u).abs() * y           # (N, K)
    return per_elem, per_elem.sum(dim=1)


def _masked_bin_mean_ema(values: torch.Tensor, bins: torch.Tensor,
                         valid: torch.Tensor, accum: torch.Tensor,
                         momentum: float, num_bins: int) -> torch.Tensor:
    """EMA accum[b] toward mean(values | bins == b) for bins with members
    (cls_loss.py:264-267); invalid rows belong to no bin. Each bin's sum
    is a reduction over a one-hot membership mask, not an index_add: on
    the card index_add adds with atomics in no fixed order, so the state
    of one step from one input would differ in its last bits from run to
    run."""
    member = valid[:, None] & (
        bins[:, None] == torch.arange(num_bins, device=bins.device))
    sums = torch.where(member, values[:, None],
                       torch.zeros_like(values)[:, None]).sum(0)
    counts = member.sum(0)
    means = sums / counts.clamp_min(1).to(sums.dtype)
    has = counts > 0
    return torch.where(has, momentum * accum + (1 - momentum) * means, accum)


def evidence_loss(cfg: EDLConfig, logits: torch.Tensor,
                  target: torch.Tensor, valid: torch.Tensor,
                  state: EDLState, epoch: int
                  ) -> Tuple[torch.Tensor, EDLState]:
    """EDL loss over masked rows. logits (N, K); target (N,) int; valid
    (N,) bool (invalid rows add no loss and no bin statistics). Returns
    (sum or mean over valid rows, new state)."""
    k = cfg.num_classes
    y = _one_hot_soft(target, k, cfg.soft_label)
    alpha = evidence_func(logits, cfg.evidence) + 1.0
    validf = valid.float()

    if cfg.loss_type == 'mse':
        s = alpha.sum(dim=1, keepdim=True)
        err = ((y - alpha / s) ** 2).sum(dim=1)
        var = (alpha * (s - alpha) / (s * s * (s + 1.0))).sum(dim=1)
        return _reduce(err + var, validf, cfg.size_average), state

    base = _edl_base(y, alpha, cfg.loss_type)         # (N, K)
    plain = base.sum(dim=1)
    new_state = state

    if cfg.with_focal:
        alpha_vec = torch.full((k,), 1.0 - cfg.alpha, device=logits.device)
        alpha_vec[0] = cfg.alpha
        s = alpha.sum(dim=1, keepdim=True)
        pred_scores = (alpha / s).amax(dim=1)
        w = alpha_vec[target.long()] * (1.0 - pred_scores) ** cfg.gamma
        per_row = (w[:, None] * base).sum(dim=1)
    elif cfg.with_ghm:
        per_elem, _ = _grad_norm_terms(y, alpha, k)
        edges = torch.arange(cfg.num_bins + 1, dtype=torch.float32,
                             device=logits.device) / cfg.num_bins
        edges[-1] += 1e-6
        bin_idx = (torch.searchsorted(edges, per_elem.reshape(-1),
                                      right=True) - 1
                   ).clamp(0, cfg.num_bins - 1)
        elem_valid = valid.repeat_interleave(k)
        slots = torch.where(elem_valid, bin_idx,
                            torch.full_like(bin_idx, cfg.num_bins))
        counts = torch.zeros(cfg.num_bins + 1, device=logits.device
                             ).index_add(0, slots,
                                         torch.ones_like(per_elem.reshape(-1))
                                         )[:cfg.num_bins]
        has = counts > 0
        if cfg.momentum > 0:
            acc = torch.where(has, cfg.momentum * state.acc_sum
                              + (1 - cfg.momentum) * counts, state.acc_sum)
            denom = torch.where(has, acc, torch.ones_like(acc))
        else:
            acc = counts
            denom = torch.where(has, counts, torch.ones_like(counts))
        w_bins = torch.where(has, 1.0 / denom, torch.zeros_like(denom))
        n_valid_bins = has.float().sum().clamp_min(1.0)
        weights = (w_bins[bin_idx] / n_valid_bins).reshape(per_elem.shape)
        active = epoch >= cfg.ghm_start
        per_row = (weights * base).sum(dim=1) if active else plain
        if cfg.momentum > 0 and active:
            new_state = new_state._replace(acc_sum=acc)
    elif cfg.with_ibloss:
        _, grad_norm = _grad_norm_terms(y, alpha, k)
        feat_norm = logits.detach().abs().sum(dim=1)
        w = 1.0 / (grad_norm * feat_norm).clamp_min(EPS)
        per_row = w * plain if epoch >= cfg.ib_start else plain
    elif cfg.with_ibm and cfg.ibm_exp:
        # exp-form influence balancing (anet/cls_loss.py:225-231); its
        # feat_norm is NOT detached, as in the reference
        _, grad_norm = _grad_norm_terms(y, alpha, k)
        feat_norm = logits.abs().sum(dim=1)
        w = 1.0 / (feat_norm * torch.exp(cfg.ibm_coeff * grad_norm) + EPS)
        per_row = w * plain if epoch >= cfg.ibm_start else plain
    elif cfg.with_ibm:
        # MIB (the OpenTAL-final variant, cls_loss.py:257-270):
        # momentum-binned importance weights over grad-norm bins
        _, grad_norm = _grad_norm_terms(y, alpha, k)
        feat_norm = logits.detach().abs().sum(dim=1)
        grad_hat = grad_norm * feat_norm
        bin_locs = torch.ceil(grad_norm * cfg.num_bins).to(torch.int64)
        # the reference indexes weight_accum[bin_locs - 1]: bin 0 wraps to
        # the last slot, as torch's negative indexing does
        idx = torch.remainder(bin_locs - 1, cfg.num_bins)
        if epoch >= cfg.ibm_start:
            accum = _masked_bin_mean_ema(grad_hat, idx, valid,
                                         state.weight_accum, cfg.momentum,
                                         cfg.num_bins)
            per_row = accum[idx] * plain
            new_state = new_state._replace(weight_accum=accum)
        else:
            per_row = plain
    else:
        per_row = plain

    return _reduce(per_row, validf, cfg.size_average), new_state


def _reduce(per_row: torch.Tensor, validf: torch.Tensor,
            size_average: bool) -> torch.Tensor:
    total = (per_row * validf).sum()
    if size_average:
        return total / validf.sum().clamp_min(1.0)
    return total


def iou_calibration(cfg: EDLConfig, logits: torch.Tensor,
                    ious: torch.Tensor, mean: bool = True) -> torch.Tensor:
    """IoU-aware uncertainty calibration (cls_loss.py:120-129):
    -iou log(1 - u) - (1 - iou) log(u) over all refined logits."""
    ious = torch.where(ious < 0, torch.full_like(ious, 1e-3), ious)
    alpha = evidence_func(logits, cfg.evidence) + 1.0
    u = cfg.num_classes / alpha.sum(dim=-1)
    reg = -ious * torch.log(1.0 - u) - (1.0 - ious) * torch.log(u)
    return reg.mean() if mean else reg.sum()
