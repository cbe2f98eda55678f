"""Positive-unlabeled objectives (port of topaz_tpu/train/methods.py:33-217,
the reference's topaz/methods.py:25-323: PN, GE-binomial, GE-KL, PU).

Each objective maps (scores, labels, state) -> (loss, new state, metrics),
all tensors on the scores' device, so that a training step needs no host
round trip:
  * the batch's composition is the labels vector ``y`` (1 positive, 0
    unlabeled), as the reference's ``step(X, Y)`` selects by ``Y``; the
    class means are masked reductions, so the composition may vary from
    batch to batch.
  * GE-binomial's count vector spans k = 0..B with the entries above the
    unlabeled count masked out of the softmax (``-inf``), which equals the
    reference's k = 0..N vector; the binomial log-pmf uses ``torch.lgamma``.
  * nnPU's clipping branch is a ``torch.where``.
  * GE-KL's running expectation is explicit state.
The metrics are the reference's TSV columns.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

HEADERS = {
    "PN": ["loss", "precision", "adjusted_precision", "tpr", "fpr"],
    "GE-binomial": ["loss", "ge_penalty", "precision", "adjusted_precision", "tpr", "fpr"],
    "GE-KL": ["loss", "ge_penalty", "precision", "adjusted_precision", "tpr", "fpr"],
    "PU": ["loss", "precision", "adjusted_precision", "tpr", "fpr"],
}

Metrics = Dict[str, torch.Tensor]


def bce_with_logits(score: torch.Tensor, target) -> torch.Tensor:
    """Elementwise binary cross-entropy on logits (torch BCEWithLogitsLoss)."""
    return score.clamp_min(0) - score * target + torch.log1p(torch.exp(-score.abs()))


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """mean(x[mask]), 0 when the mask is empty."""
    return torch.sum(x * mask) / torch.clamp_min(torch.sum(mask), 1.0)


def _classifier_metrics(score: torch.Tensor, y: torch.Tensor) -> Metrics:
    p_hat = torch.sigmoid(score)
    return {"precision": torch.sum(p_hat * y) / torch.sum(p_hat),
            "tpr": _masked_mean(p_hat, y), "fpr": _masked_mean(p_hat, 1.0 - y)}


@dataclass
class MethodState:
    """Objective-specific running state (GE-KL's expectation)."""

    running_expectation: torch.Tensor


def init_method_state(pi: Optional[float], device="cpu") -> MethodState:
    """Fresh running state (GE-KL's running expectation starts at pi)."""
    return MethodState(torch.tensor(pi if pi else 0.0, dtype=torch.float32, device=device))


def pn_loss(score, y, pi: Optional[float],
            state: MethodState) -> Tuple[torch.Tensor, MethodState, Metrics]:
    """Positive-negative with pi-weighted class means (methods.py:39-74)."""
    if pi is not None:
        loss = (_masked_mean(bce_with_logits(score, 1.0), y) * pi
                + _masked_mean(bce_with_logits(score, 0.0), 1.0 - y) * (1 - pi))
    else:
        loss = torch.mean(bce_with_logits(score, y))
    return loss, state, {"loss": loss, **_classifier_metrics(score, y)}


def ge_binomial_loss(score, y, pi: float, state: MethodState, slack: float = 1.0,
                     entropy_penalty: float = 0.0) -> Tuple[torch.Tensor, MethodState, Metrics]:
    """GE-binomial (methods.py:98-165): a Normal approximation to the
    classifier's positive count over the unlabeled crops, penalized by its
    KL against Binomial(N, pi)."""
    u = 1.0 - y
    classifier_loss = _masked_mean(bce_with_logits(score, 1.0), y)

    n_u = torch.sum(u)
    p_hat = torch.sigmoid(score) * u
    q_mu = torch.sum(p_hat)
    q_var = torch.sum(p_hat * (1 - p_hat))

    k = torch.arange(0, score.shape[0] + 1, dtype=score.dtype, device=score.device)
    valid = k <= n_u
    # python scalars in torch.where: a tensor made from one here would be a
    # host-to-device copy, which synchronizes the host with the device
    q_logits = torch.where(valid, -0.5 * (q_mu - k) ** 2 / (q_var + 1e-10), -math.inf)
    q_discrete = torch.softmax(q_logits, dim=0)
    nk = torch.where(valid, n_u - k, 0.0)  # lgamma(<0) would spoil the mask
    log_binom = (torch.lgamma(n_u + 1.0) - torch.lgamma(k + 1.0) - torch.lgamma(nk + 1.0)
                 + k * math.log(pi) + nk * math.log1p(-pi))
    ge_penalty = -torch.sum(torch.where(valid, log_binom, 0.0) * q_discrete)

    if entropy_penalty > 0:
        q_entropy = 0.5 * (torch.log(q_var) + math.log(2 * math.pi) + 1)
        ge_penalty = ge_penalty + q_entropy * entropy_penalty

    loss = classifier_loss + slack * ge_penalty
    return loss, state, {"loss": classifier_loss, "ge_penalty": ge_penalty,
                         **_classifier_metrics(score, y)}


def ge_kl_loss(score, y, pi: float, state: MethodState, slack: float = 10.0,
               momentum: float = 1.0,
               entropy_penalty: float = 0.0) -> Tuple[torch.Tensor, MethodState, Metrics]:
    """GE-KL (methods.py:185-255): KL between pi and the classifier's mean
    positive probability over the unlabeled crops, with an optional running
    average at ``momentum``."""
    u = 1.0 - y
    classifier_loss = _masked_mean(bce_with_logits(score, 1.0), y)
    p_hat = _masked_mean(torch.sigmoid(score), u)

    new_state = state
    if momentum < 1:
        p_hat = momentum * p_hat + (1 - momentum) * state.running_expectation
        new_state = MethodState(p_hat.detach())

    entropy = pi * math.log(pi) + (1 - pi) * math.log1p(-pi)
    ge_penalty = -torch.log(p_hat) * pi - torch.log1p(-p_hat) * (1 - pi) + entropy
    ge_penalty = ge_penalty * slack / momentum

    loss = classifier_loss + ge_penalty
    if entropy_penalty > 0:
        abs_score = score.abs()
        ent = abs_score * torch.sigmoid(-abs_score) - F.logsigmoid(abs_score)
        loss = loss + entropy_penalty * _masked_mean(ent, u)
    return loss, new_state, {"loss": classifier_loss, "ge_penalty": ge_penalty,
                             **_classifier_metrics(score, y)}


def pu_loss(score, y, pi: float, state: MethodState,
            beta: float = 0.0) -> Tuple[torch.Tensor, MethodState, Metrics]:
    """Non-negative PU (methods.py:274-322, arXiv:1703.00593): when the
    estimated negative-data loss drops below -beta, step along its negated
    gradient instead."""
    loss_pp = _masked_mean(bce_with_logits(score, 1.0), y)
    loss_pn = _masked_mean(bce_with_logits(score, 0.0), y)
    loss_un = _masked_mean(bce_with_logits(score, 0.0), 1.0 - y)

    loss_u = loss_un - loss_pn * pi
    clip = loss_u < -beta
    backprop_loss = torch.where(clip, -loss_u, loss_pp * pi + loss_u)
    reported = torch.where(clip, loss_pp * pi - beta, loss_pp * pi + loss_u)
    return backprop_loss, state, {"loss": reported, **_classifier_metrics(score, y)}


def make_loss_fn(method: str, pi: Optional[float], slack: float = -1.0,
                 entropy_penalty: float = 0.0, momentum: float = 1.0, beta: float = 0.0):
    """(loss_fn, header, split) for a method name, with the reference's
    slack defaults (training.py:380-390): 10 for GE-KL, 1 for GE-binomial.
    ``entropy_penalty``, ``momentum`` and ``beta`` default to the values the
    reference hardcodes (methods.py:80,170-171,260-261)."""
    if method == "PN":
        return (lambda s, y, st: pn_loss(s, y, pi, st)), HEADERS["PN"], "pn"
    if method == "GE-binomial":
        sl = 1.0 if slack < 0 else slack
        return (lambda s, y, st: ge_binomial_loss(
            s, y, pi, st, slack=sl, entropy_penalty=entropy_penalty)), \
            HEADERS["GE-binomial"], "pn"
    if method == "GE-KL":
        sl = 10.0 if slack < 0 else slack
        return (lambda s, y, st: ge_kl_loss(
            s, y, pi, st, slack=sl, momentum=momentum,
            entropy_penalty=entropy_penalty)), HEADERS["GE-KL"], "pn"
    if method == "PU":
        return (lambda s, y, st: pu_loss(s, y, pi, st, beta=beta)), HEADERS["PU"], "pu"
    raise ValueError("Invalid method: " + method)
