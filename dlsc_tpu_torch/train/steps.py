"""Train and eval steps, AST mode.

Counterpart of ``dlsc_tpu/train/steps.py`` ``make_train_step`` (accum 1)
and ``make_eval_step``. One call of the train step runs: waveform batch →
``DevicePipeline.train_batch`` (log-mel on kernel K1, SpecAugment, Mixup;
outside the autograd graph, the JAX step's ``stop_gradient``) → forward in
train mode (kernel K2f in each block, remat as the model is configured) →
soft-label loss → backward (kernel K2b) → global-norm clip → optimizer
update at this step's LR → metric update with the pre-update outputs.

The step's random draws come from ``state.step_rng()`` unless ``draws=``
hands them in (tests give both packages the same draws). Gradient
accumulation waits for the trainer that uses it (ROADMAP M9).
"""

from __future__ import annotations

from typing import Callable

import torch

from dlsc_tpu_torch.data.pipeline import DevicePipeline, TrainDraws
from dlsc_tpu_torch.models.vit import AttentionFn
from dlsc_tpu_torch.ops.augment import one_hot
from dlsc_tpu_torch.train.metrics import MetricState
from dlsc_tpu_torch.train.state import TrainState


def make_train_step(pipeline: DevicePipeline, criterion: Callable,
                    attention: AttentionFn | None = None) -> Callable:
    """``train_step(state, ms, wave, labels, draws=None) -> (state, ms, loss)``;
    ``state`` is updated in place and returned. ``attention`` replaces the
    model's attention (e.g. ``mha_forward_reference``, plain ops under
    autograd) when given."""

    def train_step(state: TrainState, ms: MetricState, wave: torch.Tensor,
                   labels: torch.Tensor, draws: TrainDraws | None = None):
        if draws is None:
            draws = pipeline.draw(wave.shape[0], wave.shape[-1], state.step_rng())
        x, y = pipeline.train_batch(wave, labels, draws)
        model = state.model.train()
        logits = model(x) if attention is None else model(x, attention=attention)
        loss = criterion(logits, y)
        loss.backward()
        state.apply_gradients()
        loss = loss.detach()
        return state, ms.update(logits.detach(), y.argmax(-1), loss), loss

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
