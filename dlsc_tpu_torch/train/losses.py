"""Soft-label losses.

Counterpart of ``dlsc_tpu/train/losses.py``: the reference always feeds soft
labels (one-hot or mixed) and branches on the criterion class:

- ``CrossEntropyLoss``: ``-sum(y * log(softmax(logits) + 1e-8))``, averaged
  over the batch;
- ``KLDivLoss`` (``batchmean`` by default): ``sum(y * (log y - log_softmax))``
  with 0 log 0 = 0.

Both take optional label smoothing and a per-sample mask (eval batches
padded to a fixed size). The AST models output sigmoid probabilities, and
these losses treat them as logits, as the reference does (quirk kept).
"""

from __future__ import annotations

import dataclasses

import torch


def _smooth(targets: torch.Tensor, label_smoothing: float) -> torch.Tensor:
    if label_smoothing <= 0:
        return targets
    return targets * (1.0 - label_smoothing) + label_smoothing / targets.shape[-1]


def _reduce(per: torch.Tensor, mask: torch.Tensor | None, reduction: str) -> torch.Tensor:
    if mask is not None:
        per = per * mask
        n = mask.sum().clamp_min(1)
    else:
        n = per.shape[0]
    if reduction == "mean":
        return per.sum() / n
    if reduction == "sum":
        return per.sum()
    return per


@dataclasses.dataclass(frozen=True)
class CrossEntropyLoss:
    """Soft cross-entropy with optional label smoothing."""

    label_smoothing: float = 0.0
    reduction: str = "mean"

    def __call__(self, logits: torch.Tensor, targets: torch.Tensor,
                 mask: torch.Tensor | None = None) -> torch.Tensor:
        y = _smooth(targets, self.label_smoothing)
        probs = torch.softmax(logits.float(), dim=-1)
        per = -(y * torch.log(probs + 1e-8)).sum(-1)
        return _reduce(per, mask, self.reduction)


@dataclasses.dataclass(frozen=True)
class KLDivLoss:
    """``torch.nn.KLDivLoss(log_probs, probs)`` on soft labels; ``batchmean``
    by default, ``mean`` divides by the element count (B * C)."""

    reduction: str = "batchmean"
    label_smoothing: float = 0.0

    def __call__(self, logits: torch.Tensor, targets: torch.Tensor,
                 mask: torch.Tensor | None = None) -> torch.Tensor:
        y = _smooth(targets, self.label_smoothing)
        log_q = torch.log_softmax(logits.float(), dim=-1)
        per = (torch.xlogy(y, y) - y * log_q).sum(-1)
        if self.reduction == "batchmean":
            if mask is not None:
                return (per * mask).sum() / mask.sum().clamp_min(1)
            return per.mean()
        if self.reduction == "mean":
            return _reduce(per, mask, "mean") / targets.shape[-1]
        return _reduce(per, mask, self.reduction)
