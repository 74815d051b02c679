"""Train and eval steps, AST mode.

Counterpart of ``dlsc_tpu/train/steps.py`` ``make_train_step`` (accum 1)
and ``make_eval_step``. One call of the train step runs: waveform batch →
``DevicePipeline.train_batch`` (log-mel on kernel K1, SpecAugment, Mixup;
outside the autograd graph, the JAX step's ``stop_gradient``) → forward in
train mode (kernel K2f in each block, remat as the model is configured) →
soft-label loss plus the MoE blocks' aux loss → backward (kernel K2b; K4
in MoE blocks; K3 with ``ln_fused``) → global-norm clip → optimizer update at this step's LR →
metric update with the pre-update outputs and the MoE stats (the metric
state's extras, when it was created with ``MOE_METRICS``).

The step's random draws, and the seed of its dropout masks, come from
``state.step_rng()`` unless ``draws=`` and ``dropout_seed=`` hand them in
(tests give both packages the same draws). Gradient accumulation waits for
the trainer that uses it (ROADMAP M9).
"""

from __future__ import annotations

from typing import Callable

import torch

from dlsc_tpu_torch.data.pipeline import DevicePipeline, TrainDraws
from dlsc_tpu_torch.ops.augment import one_hot
from dlsc_tpu_torch.train.metrics import MetricState
from dlsc_tpu_torch.train.state import TrainState


def make_train_step(pipeline: DevicePipeline, criterion: Callable, **ops) -> Callable:
    """``train_step(state, ms, wave, labels, draws=None, dropout_seed=None)
    -> (state, ms, loss)``; ``state`` is updated in place and returned.
    ``ops`` that are not None replace the model's (``ASTViT.forward``'s
    ``attention``, ``grouped_matmul``, ``topk``, ``add_ln``: e.g. the plain
    ``mha_forward_reference``, ``gmm_reference`` and ``add_ln_reference``
    under autograd, or a router choice replayed from another run)."""
    ops = {k: v for k, v in ops.items() if v is not None}

    def train_step(state: TrainState, ms: MetricState, wave: torch.Tensor,
                   labels: torch.Tensor, draws: TrainDraws | None = None,
                   dropout_seed: int | None = None):
        rng = state.step_rng() if draws is None or dropout_seed is None else None
        if draws is None:
            draws = pipeline.draw(wave.shape[0], wave.shape[-1], rng)
        if dropout_seed is None:
            dropout_seed = int(rng.integers(2**62))
        x, y = pipeline.train_batch(wave, labels, draws)
        model = state.model.train()
        logits, aux, stats = model(x, dropout_seed=dropout_seed, return_aux=True, **ops)
        loss = criterion(logits, y) + aux
        loss.backward()
        state.apply_gradients()
        loss = loss.detach()
        ms = ms.update(logits.detach(), y.argmax(-1), loss).add_extras(stats)
        return state, ms, loss

    return train_step


def make_eval_step(pipeline: DevicePipeline, criterion: Callable) -> Callable:
    """``eval_step(state, ms, wave, labels, mask) -> (ms, logits)``: eval
    features, the model in eval mode without autograd, the masked loss."""

    def eval_step(state: TrainState, ms: MetricState, wave: torch.Tensor,
                  labels: torch.Tensor, mask: torch.Tensor):
        with torch.no_grad():
            model = state.model.eval()
            x = pipeline.eval_batch(wave)
            y = one_hot(labels.to(x.device), pipeline.cfg.num_classes)
            logits = model(x)
            loss = criterion(logits, y, mask=mask.to(x.device, torch.float32))
            return ms.update(logits, y.argmax(-1), loss, mask=mask), logits

    return eval_step
