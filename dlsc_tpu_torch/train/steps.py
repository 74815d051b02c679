"""Train and eval steps, for every model family.

Counterpart of ``dlsc_tpu/train/steps.py``. One call of the train step
runs: waveform batch → ``DevicePipeline.train_batch`` (outside the autograd
graph, the JAX step's ``stop_gradient``: for AST log-mel on kernel K1,
SpecAugment, Mixup; for EnvNet-v2 and LEAF pad, crop, stretch, gain, BC
mixing; for the CNN log-mel on K1, resize, flips and shift) → forward in
train mode (for AST kernel K2f in each block, remat as the model is
configured; BatchNorm layers update their running statistics here, as the
JAX step threads ``batch_stats`` through ``mutable``) → soft-label loss
plus the MoE blocks' aux loss → backward (kernel K2b; K4 in MoE blocks; K3
with ``ln_fused``) → global-norm clip → optimizer update at this step's LR
→ metric update with the pre-update outputs and the MoE stats (the metric
state's extras, when it was created with ``MOE_METRICS``). The eval step
averages the per-crop outputs of a multi-crop pipeline
(``DevicePipeline.forward_eval``).

``accum`` > 1 is gradient accumulation (``_make_train_step_accum`` there):
the batch is split into ``accum`` micro-batches run one after the other,
each with its own draws and dropout seed and its own metric update, and the
optimizer updates once with the mean of their gradients. As in the JAX
package the wire batch is the global batch, so Lightning's
``accumulate_grad_batches=M`` over loader batches is batch_size x M here.

The step's random draws, and the seed of its dropout masks, come from
``state.step_rng()`` unless ``draws=`` and ``dropout_seed=`` hand them in
(tests give both packages the same draws); with ``accum`` > 1 they are
sequences, one entry per micro-batch. The ``*_indexed`` steps take the
waveforms from a pool on the device (the Trainer's device-resident
dataset) by an index vector.

Under data parallelism (``state.parallel``, ``parallel/``) ``wave`` and
``labels`` are still the global batch, as under the JAX mesh, and so are
the draws and the dropout seed: every rank draws the same. A rank computes
the inputs of its rows (``DevicePipeline.train_batch_rows``), runs the
model on them with ``rows=`` so that its dropout masks are the global
batch's, and its loss is the mean over its rows: the ranks' gradients,
averaged by DDP (or reduced by FSDP, or by ``parallel.sync_grads``), are
the global batch's. BatchNorm statistics and the MoE aux loss are reduced
over the ranks inside the model. ``accum`` micro-batches are slices of the
global batch, each split over the ranks. Under pipeline parallelism the
step is ``parallel/pp.py``'s GPipe schedule. The eval step computes the
metrics of the rank's rows; the Trainer reduces the metric states.
"""

from __future__ import annotations

import contextlib

from typing import Callable

import torch

from dlsc_tpu_torch.data.pipeline import DevicePipeline
from dlsc_tpu_torch.ops.augment import one_hot
from dlsc_tpu_torch.train.metrics import MetricState
from dlsc_tpu_torch.train.state import TrainState


def make_train_step(pipeline: DevicePipeline, criterion: Callable, accum: int = 1,
                    **ops) -> Callable:
    """``train_step(state, ms, wave, labels, draws=None, dropout_seed=None)
    -> (state, ms, loss)``; ``state`` is updated in place and returned, and
    ``loss`` is the mean over the micro-batches. ``ops`` that are not None
    replace the model's (``ASTViT.forward``'s ``attention``,
    ``grouped_matmul``, ``topk``, ``add_ln``: e.g. the plain
    ``mha_forward_reference``, ``gmm_reference`` and ``add_ln_reference``
    under autograd, or a router choice replayed from another run)."""
    ops = {k: v for k, v in ops.items() if v is not None}

    def train_step(state: TrainState, ms: MetricState, wave: torch.Tensor,
                   labels: torch.Tensor, draws=None, dropout_seed=None):
        if wave.shape[0] % accum:
            raise ValueError(f"batch size {wave.shape[0]} not divisible by "
                             f"accumulate_grad_batches={accum}")
        mb = wave.shape[0] // accum
        rng = state.step_rng() if draws is None or dropout_seed is None else None
        if accum == 1:
            draws, dropout_seed = [draws], [dropout_seed]
        par = state.parallel
        state.model.train()
        loss_sum = 0.0
        for i in range(accum):
            w, lab = wave[i * mb:(i + 1) * mb], labels[i * mb:(i + 1) * mb]
            d = pipeline.draw(mb, w.shape[-1], rng) if draws is None or draws[i] is None \
                else draws[i]
            seed = int(rng.integers(2**62)) if dropout_seed is None or dropout_seed[i] is None \
                else dropout_seed[i]
            if par is not None and par.runs_step:
                loss, logits, y, stats = par.train_micro(pipeline, criterion, w, lab, d, seed,
                                                         accum, ops)
            else:
                lo, hi = (0, mb) if par is None else par.plan.rows(mb)
                x, y = pipeline.train_batch_rows(w, lab, d, lo, hi)
                rows = None if par is None or par.plan.n_batch == 1 else (lo, mb)
                module = state.model if par is None else par.module
                last = i == accum - 1
                with (par.no_sync() if par is not None and not last
                      else contextlib.nullcontext()):
                    logits, aux, stats = module(x, dropout_seed=seed, return_aux=True,
                                                rows=rows, **ops)
                    loss = criterion(logits, y) + aux
                    (loss / accum).backward()   # accum 1: the same gradients, bit for bit
                loss = loss.detach()
            ms = ms.update(logits.detach(), y.argmax(-1), loss).add_extras(stats)
            loss_sum = loss_sum + loss
        state.apply_gradients()
        if par is not None:   # the global batch's loss, as the one-process step's
            loss_sum = par.mean_over_batch(loss_sum)
        return state, ms, loss_sum / accum

    return train_step


def make_train_step_indexed(pipeline: DevicePipeline, criterion: Callable, accum: int = 1,
                            **ops) -> Callable:
    """``train_step(state, ms, pool, idx, labels, ...)``: the train step on
    the rows ``idx`` of ``pool`` (N, T), gathered on the pool's device."""
    base = make_train_step(pipeline, criterion, accum, **ops)

    def train_step(state: TrainState, ms: MetricState, pool: torch.Tensor,
                   idx: torch.Tensor, labels: torch.Tensor, **kw):
        return base(state, ms, pool.index_select(0, idx), labels, **kw)

    return train_step


def make_eval_step(pipeline: DevicePipeline, criterion: Callable) -> Callable:
    """``eval_step(state, ms, wave, labels, mask) -> (ms, logits)``: eval
    features, the model in eval mode without autograd (the mean over crops
    for a multi-crop pipeline), the masked loss."""

    def eval_step(state: TrainState, ms: MetricState, wave: torch.Tensor,
                  labels: torch.Tensor, mask: torch.Tensor):
        with torch.no_grad():
            par = state.parallel
            state.model.eval()
            if par is not None:   # this rank's rows of the global batch
                lo, hi = par.plan.rows(wave.shape[0])
                wave, labels, mask = wave[lo:hi], labels[lo:hi], mask[lo:hi]
            x = pipeline.eval_batch(wave)
            y = one_hot(labels.to(x.device), pipeline.cfg.num_classes)
            if par is not None and par.runs_step:
                logits = par.eval_forward(pipeline, x)
            else:
                logits = pipeline.forward_eval(state.model if par is None else par.module, x)
            loss = criterion(logits, y, mask=mask.to(x.device, torch.float32))
            return ms.update(logits, y.argmax(-1), loss, mask=mask), logits

    return eval_step


def make_eval_step_indexed(pipeline: DevicePipeline, criterion: Callable) -> Callable:
    """``eval_step(state, ms, pool, idx, labels, mask) -> (ms, logits)``."""
    base = make_eval_step(pipeline, criterion)

    def eval_step(state: TrainState, ms: MetricState, pool: torch.Tensor,
                  idx: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor):
        return base(state, ms, pool.index_select(0, idx), labels, mask)

    return eval_step
