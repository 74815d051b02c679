"""Streaming classification metrics.

Counterpart of ``dlsc_tpu/train/metrics.py``: accuracy, macro F1 and
per-class accuracy stream through one (C, C) confusion matrix ([true,
pred]) kept on the device with the loss sum and the sample and batch
counts, so a step never waits on the host. AUROC needs whole score
distributions: ``macro_auroc`` takes (probs, labels) collected on the host
(numpy, copied from the JAX package). Auxiliary per-batch scalars (the MoE
stats, ``models/moe.py`` ``MOE_METRICS``) stream as sums when the state is
created with their names (``extras``), as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class MetricState:
    confmat: torch.Tensor   # (C, C) int64: [true, pred]
    loss_sum: torch.Tensor  # f32, sum of per-batch mean loss x valid samples
    count: torch.Tensor     # int64, samples
    batches: torch.Tensor   # int64
    extra_sums: dict[str, torch.Tensor] | None = None  # f32 sums of per-batch scalars

    @classmethod
    def create(cls, num_classes: int, device: torch.device | str | None = None,
               extras: tuple[str, ...] = ()) -> "MetricState":
        z = torch.zeros((), dtype=torch.int64, device=device)
        sums = {k: torch.zeros((), dtype=torch.float32, device=device) for k in extras}
        return cls(torch.zeros((num_classes, num_classes), dtype=torch.int64, device=device),
                   torch.zeros((), dtype=torch.float32, device=device), z, z.clone(),
                   sums or None)

    def add_extras(self, values: dict[str, torch.Tensor]) -> "MetricState":
        """Add this batch's auxiliary scalars to the sums of the names this
        state was created with; other names are ignored."""
        if self.extra_sums is None or not values:
            return self
        sums = {k: v + values[k].detach().float() if k in values else v
                for k, v in self.extra_sums.items()}
        return dataclasses.replace(self, extra_sums=sums)

    def extra_means(self) -> dict[str, torch.Tensor]:
        """Per-batch means of the auxiliary scalars."""
        if self.extra_sums is None:
            return {}
        b = self.batches.clamp_min(1)
        return {k: v / b for k, v in self.extra_sums.items()}

    @torch.no_grad()
    def update(self, logits: torch.Tensor, hard_labels: torch.Tensor, loss: torch.Tensor,
               mask: torch.Tensor | None = None) -> "MetricState":
        """``loss`` is the batch's mean over valid samples; it is weighted by
        the valid count, so ``mean_loss`` is exact over ragged batches."""
        C = self.confmat.shape[0]
        preds = logits.argmax(-1)
        valid = (torch.ones_like(hard_labels, dtype=torch.int64) if mask is None
                 else mask.to(torch.int64))
        upd = torch.zeros(C * C, dtype=torch.int64, device=self.confmat.device)
        upd.index_add_(0, (hard_labels.long() * C + preds).to(upd.device), valid.to(upd.device))
        n_valid = valid.sum().to(self.count.device)
        return MetricState(self.confmat + upd.view(C, C),
                           self.loss_sum + loss.detach().float() * n_valid,
                           self.count + n_valid, self.batches + 1, self.extra_sums)


def accuracy(ms: MetricState) -> torch.Tensor:
    """Micro top-1."""
    return ms.confmat.trace() / ms.confmat.sum().clamp_min(1)


def mean_loss(ms: MetricState) -> torch.Tensor:
    return ms.loss_sum / ms.count.clamp_min(1)


def per_class_accuracy(ms: MetricState) -> torch.Tensor:
    """Recall per class; 0 where a class has no support."""
    support = ms.confmat.sum(1)
    return torch.where(support > 0, ms.confmat.diag() / support.clamp_min(1),
                       torch.zeros((), dtype=torch.float32, device=support.device))


def macro_f1(ms: MetricState) -> torch.Tensor:
    """Macro F1 over the classes with support."""
    cm = ms.confmat
    tp = cm.diag().float()
    fp = cm.sum(0) - tp
    fn = cm.sum(1) - tp
    f1 = 2 * tp / (2 * tp + fp + fn).clamp_min(1e-9)
    present = (tp + fn) > 0
    return torch.where(present, f1, 0.0).sum() / present.sum().clamp_min(1)


def macro_auroc(probs: np.ndarray, labels: np.ndarray, num_classes: int) -> float:
    """One-vs-rest macro AUROC from collected scores, average ranks for ties."""
    aucs = []
    for c in range(num_classes):
        pos = labels == c
        n_pos, n_neg = int(pos.sum()), int((~pos).sum())
        if n_pos == 0 or n_neg == 0:
            continue
        order = np.argsort(probs[:, c], kind="mergesort")
        ranks = np.empty(len(order), dtype=np.float64)
        sorted_scores = probs[order, c]
        ranks_sorted = np.arange(1, len(order) + 1, dtype=np.float64)
        i = 0
        while i < len(order):
            j = i
            while j + 1 < len(order) and sorted_scores[j + 1] == sorted_scores[i]:
                j += 1
            ranks_sorted[i : j + 1] = 0.5 * (i + 1 + j + 1)
            i = j + 1
        ranks[order] = ranks_sorted
        aucs.append((ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))
    return float(np.mean(aucs)) if aucs else 0.0
