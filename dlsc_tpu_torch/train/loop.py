"""Fit, validate and test: the Trainer.

The port's counterpart of ``dlsc_tpu/train/loop.py`` (the functional
replacement for the reference's Lightning ``Trainer`` + ``LitClassifier``):

- the epoch loop with train and val phases and the reference's metric names
  (``train/acc``, ``train/loss``, ``val/acc``, ``val/loss``, ``lr``) plus
  ``perf/clips_per_sec_per_chip`` and, for MoE models, ``MOE_METRICS``;
- ``CheckpointManager`` on ``val/acc`` (best k, ``last``, resume from
  ``ckpt_path`` or, with ``auto_resume``, from the newest checkpoint),
  ``EarlyStopping``, optional SWA with its BatchNorm refresh, ``callbacks`` with
  ``on_validation_epoch_end(trainer, epoch, metrics)``;
- ``limit_train_batches`` / ``limit_val_batches``, ``check_val_every_n_epoch``;
- the test phase: acc, macro F1, macro AUROC, loss, confusion matrix and
  per-class accuracy, figures when matplotlib is there (the arrays are
  logged either way).

The step is ``train/steps.py``'s, eager: for AST K1 → SpecAugment → Mixup
→ the ViT (K2f, K2b; K3 and K4 where the model has them) → CE → clip →
update; for EnvNet-v2, the CNN and LEAF their pipelines → the CNN (cuDNN
convolutions, BatchNorm updating its running statistics) → the loss → clip
→ update. SWA ends with a pass that re-estimates the BatchNorm statistics
of the averaged weights (``_refresh_batch_stats``). The
host waits on the card only where the JAX loop does: ``float(loss)`` every
``log_every_n_steps`` when a tracker is given, and once at each epoch's end;
the metric states stay on the device until then.

Data reaches the card one of two ways:

- the device-resident pool (``device_data='auto'``, on when the pool fits the
  budget): the fold shards are uploaded once, one copy per fold part, and
  each step gathers its rows by index (``index_select``), so a step moves
  only a (B,) index and a (B,) label vector to the card;
- host batches, which a background thread (``data/loader.prefetch``) copies
  to the card through pinned memory, ``non_blocking`` on the step's stream;
  the pinned buffers stay referenced until their batch has been used.

``trainer.accelerator`` 'auto' (the configs' value) and 'gpu' run on
``cuda:0`` and raise without a GPU; 'cpu' is an explicit opt-in (the tests'),
never a fallback. Not ported, each raising ``NotImplementedError`` naming
ROADMAP §1 M12: ``devices`` > 1, ``fsdp``, ``expert_parallel`` > 1,
``pipeline_parallel`` > 1. Progress is one line per epoch (no tqdm).
"""

from __future__ import annotations

import contextlib
import inspect
import time
from pathlib import Path
from typing import Any, Callable, Sequence

import numpy as np
import torch

from dlsc_tpu_torch.data.loader import prefetch
from dlsc_tpu_torch.data.pipeline import PipelineConfig
from dlsc_tpu_torch.models.moe import MOE_METRICS
from dlsc_tpu_torch.train import metrics as MT
from dlsc_tpu_torch.train.checkpoint import (CheckpointManager, latest_checkpoint,
                                             load_params, restore_state)
from dlsc_tpu_torch.train.losses import CrossEntropyLoss
from dlsc_tpu_torch.train.optim import OptimizerSpec, SchedulerSpec
from dlsc_tpu_torch.train.state import TrainState
from dlsc_tpu_torch.train.steps import (make_eval_step, make_eval_step_indexed,
                                        make_train_step, make_train_step_indexed)

def resolve_device(accelerator: str = "auto") -> torch.device:
    """``trainer.accelerator`` → the device: 'auto', 'gpu' and 'cuda' are
    ``cuda:0`` and raise without a GPU; 'cpu' is the CPU."""
    acc = str(accelerator).lower()
    if acc in ("auto", "gpu", "cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"trainer.accelerator={accelerator!r} needs a GPU, and "
                "torch.cuda.is_available() is False; pass trainer.accelerator=cpu to run "
                "on the CPU")
        return torch.device("cuda", 0)
    if acc == "cpu":
        return torch.device("cpu")
    raise ValueError(f"trainer.accelerator={accelerator!r}: the port runs on 'gpu' "
                     "('auto') or 'cpu'")


class EarlyStopping:
    """Stop when the monitored val metric stops improving (reference:
    callbacks.py:59-63)."""

    def __init__(self, monitor="val/acc", mode="max", patience=40, min_delta=0.001):
        self.monitor, self.mode = monitor, mode
        self.patience, self.min_delta = patience, min_delta
        self.best = -np.inf if mode == "max" else np.inf
        self.bad_epochs = 0

    def update(self, metrics: dict) -> bool:
        v = metrics.get(self.monitor)
        if v is None:
            return False
        improved = (v > self.best + self.min_delta if self.mode == "max"
                    else v < self.best - self.min_delta)
        if improved:
            self.best, self.bad_epochs = v, 0
        else:
            self.bad_epochs += 1
        return self.bad_epochs >= self.patience


class _SWA:
    """Stochastic Weight Averaging (Lightning's SWA callback, reference:
    callbacks.py:71-79): the running mean of the parameters at each epoch's
    end from ``swa_epoch_start`` on replaces the weights when fit ends.
    ``swa_lrs`` bakes SWA's annealing into the LR (``optim.swa_lr_wrap``).
    The Trainer then refreshes the BatchNorm statistics of the averaged
    weights (``Trainer._refresh_batch_stats``)."""

    def __init__(self, swa_epoch_start: float | int = 0.8, max_epochs: int = 100,
                 swa_lrs: float | None = None, annealing_epochs: int = 10, **_):
        if isinstance(swa_epoch_start, float) and swa_epoch_start <= 1.0:
            self.start_epoch = int(swa_epoch_start * max_epochs)
        else:
            self.start_epoch = int(swa_epoch_start)
        self.swa_lrs = None if swa_lrs is None else float(swa_lrs)
        self.annealing_epochs = int(annealing_epochs)
        self.avg_params: dict[str, torch.Tensor] | None = None
        self.n_models = 0

    @property
    def lr_cfg(self) -> dict | None:
        if self.swa_lrs is None:
            return None
        return {"swa_lr": self.swa_lrs, "start_epoch": self.start_epoch,
                "annealing_epochs": self.annealing_epochs}

    @torch.no_grad()
    def update(self, epoch: int, state: TrainState) -> None:
        if epoch < self.start_epoch:
            return
        n = self.n_models
        params = dict(state.model.named_parameters())
        if self.avg_params is None:
            self.avg_params = {k: p.detach().clone() for k, p in params.items()}
        else:
            for k, avg in self.avg_params.items():
                avg.copy_((avg * n + params[k]) / (n + 1))
        self.n_models = n + 1

    @torch.no_grad()
    def apply(self, model: torch.nn.Module) -> None:
        for k, p in model.named_parameters():
            p.copy_(self.avg_params[k])


class Trainer:
    #: share of the card's memory kept free for the step's own temporaries
    #: when sizing the device-resident pool: the JAX package's constant
    #: (``dlsc_tpu/train/loop.py`` POOL_HBM_RESERVE_FRAC), with its rule
    #: budget = free − 0.45 × total
    POOL_HBM_RESERVE_FRAC = 0.45
    POOL_FALLBACK_CAP = 6_000_000_000  # no device memory stats (the CPU)

    def __init__(
        self,
        max_epochs: int = 250,
        precision: str | int = 32,
        gradient_clip_val: float | None = None,
        log_every_n_steps: int | None = None,
        limit_train_batches: int | None = None,
        limit_val_batches: int | None = None,
        check_val_every_n_epoch: int = 1,
        enable_progress_bar: bool = True,   # config parity: progress is the epoch line
        enable_checkpointing: bool = True,
        checkpoint_dir: str | Path = "checkpoints",
        auto_resume: bool = False,  # resume from the newest checkpoint in
                                    # checkpoint_dir ('last' wins a tie)
        debug_nans: bool = False,   # autograd anomaly mode: raise at a NaN
        devices: int | str = "auto",
        accelerator: str = "auto",
        seed: int = 42,
        profile_dir: str | Path | None = None,  # torch.profiler trace of the first epoch
        device_data: bool | str = "auto",       # the device-resident pool ('auto':
                                                # on when it fits the budget)
        device_data_max_bytes: int | None = None,  # explicit pool cap; None: the
                                                   # budget from the card's free memory
        fsdp: bool = False,
        expert_parallel: int = 1,
        pipeline_parallel: int = 1,
        accumulate_grad_batches: int = 1,  # micro-batches of each batch, one update
        **_: Any,
    ):
        if devices not in ("auto", None) and int(devices) != 1:
            raise NotImplementedError(f"trainer.devices={devices}: multi-GPU training is not "
                                      "ported yet (ROADMAP §1 M12)")
        for name, value, off in (("fsdp", fsdp, False), ("expert_parallel", int(expert_parallel), 1),
                                 ("pipeline_parallel", int(pipeline_parallel), 1)):
            if value != off:
                raise NotImplementedError(f"trainer.{name}={value} is not ported yet "
                                          "(ROADMAP §1 M12)")
        self.device = resolve_device(accelerator)
        self.max_epochs = max_epochs
        self.precision = str(precision)
        self.gradient_clip_val = gradient_clip_val
        self.log_every_n_steps = log_every_n_steps
        self.limit_train_batches = limit_train_batches
        self.limit_val_batches = limit_val_batches
        self.check_val_every_n_epoch = check_val_every_n_epoch
        self.enable_checkpointing = enable_checkpointing
        self.checkpoint_dir = Path(checkpoint_dir)
        self.auto_resume = bool(auto_resume)
        self.seed = seed
        self.profile_dir = profile_dir
        self.device_data = device_data
        self.device_data_max_bytes = device_data_max_bytes
        self.accumulate_grad_batches = int(accumulate_grad_batches)
        if debug_nans:
            torch.autograd.set_detect_anomaly(True)
        self.state: TrainState | None = None
        self.ckpt_manager: CheckpointManager | None = None
        self.logged_metrics: dict[str, float] = {}
        self.history: list[dict] = []
        self.fit_seconds: float | None = None   # wall time of the last fit
        self.should_stop = False
        self._use_device_data = False
        self._dd_ready = False
        self._pool_dev = self._test_pool_dev = None
        self._train_step = self._eval_step = None

    # -- state -----------------------------------------------------------------
    def init_state(self, model, datamodule, optim_spec: OptimizerSpec,
                   sched_spec: SchedulerSpec | None, swa_lr_cfg: dict | None = None
                   ) -> TrainState:
        """The model on the trainer's device, its optimizer, the LR schedule
        over the datamodule's steps per epoch, and a generator seeded by
        ``seed``."""
        model.to(self.device)
        return TrainState.create(model, optim_spec, sched_spec,
                                 max(datamodule.steps_per_epoch, 1), self.gradient_clip_val,
                                 seed=self.seed, swa=swa_lr_cfg)

    def _make_steps(self, pipeline, criterion) -> None:
        indexed = self._use_device_data
        self._train_step = (make_train_step_indexed if indexed else make_train_step)(
            pipeline, criterion, self.accumulate_grad_batches)
        self._eval_step = (make_eval_step_indexed if indexed else make_eval_step)(
            pipeline, criterion)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- data onto the device --------------------------------------------------
    def _put(self, arr: np.ndarray) -> tuple[torch.Tensor, torch.Tensor | None]:
        """(the array on the device, the pinned host copy that must outlive
        the asynchronous transfer, or None)."""
        t = torch.from_numpy(np.asarray(arr))
        if self.device.type != "cuda":
            return t, None
        pinned = t.pin_memory()
        return pinned.to(self.device, non_blocking=True), pinned

    def _step_args(self, batch, *, train: bool) -> tuple[tuple, list]:
        """(the step's tail arguments for a host batch, the pinned buffers
        to keep until the step has been enqueued)."""
        keep = []

        def put(a):
            t, pinned = self._put(a)
            keep.append(pinned)
            return t

        if self._use_device_data:
            pool = self._test_pool_dev if batch.get("split") == "test" else self._pool_dev
            args = (pool, put(batch["idx"]), put(batch["label"]))
        else:
            args = (put(batch["wave"]), put(batch["label"]))
        if not train:
            args += (put(batch["mask"]),)
        return args, keep

    def _device_pool_budget(self) -> tuple[int, str]:
        """(pool byte budget, the arithmetic) for ``device_data='auto'``."""
        if self.device_data_max_bytes is not None:
            return int(self.device_data_max_bytes), "explicit cap"
        if self.device.type != "cuda":
            return self.POOL_FALLBACK_CAP, "fallback cap (no device memory stats)"
        free, total = torch.cuda.mem_get_info(self.device)
        reserve = int(self.POOL_HBM_RESERVE_FRAC * total)
        return max(0, free - reserve), (f"free {free / 1e9:.1f} GB − step reserve "
                                        f"{reserve / 1e9:.1f} GB of {total / 1e9:.1f} GB")

    def _upload(self, arrays: Sequence[np.ndarray]) -> torch.Tensor:
        """One device tensor holding ``arrays`` stacked, one copy per array."""
        n = sum(len(a) for a in arrays)
        first = torch.from_numpy(np.array(arrays[0][:1]))
        out = torch.empty((n,) + tuple(first.shape[1:]), dtype=first.dtype, device=self.device)
        row = 0
        for a in arrays:
            out[row:row + len(a)].copy_(torch.from_numpy(np.array(a)))
            row += len(a)
        return out

    def _setup_device_data(self, datamodule) -> None:
        """Decide on the pool and upload it, once."""
        if self._dd_ready:
            return
        self._dd_ready = True
        self._use_device_data = False
        if not self.device_data or not hasattr(datamodule, "pool_parts"):
            return
        nbytes = datamodule.pool_nbytes
        budget, why = self._device_pool_budget()
        if nbytes > budget:
            print(f"[data] device-resident pool disabled: pool {nbytes / 1e9:.2f} GB exceeds "
                  f"budget {budget / 1e9:.2f} GB ({why})")
            return
        t0 = time.perf_counter()
        parts, _, test_w, _ = datamodule.pool_parts()
        self._pool_dev = self._upload(parts)
        self._test_pool_dev = self._upload([test_w])
        self._use_device_data = True
        self._sync()
        print(f"[data] device-resident pool: {nbytes / 1e6:.0f} MB uploaded in "
              f"{time.perf_counter() - t0:.2f} s (per-step transfer: indices and labels)")

    # -- fit -------------------------------------------------------------------
    def fit(
        self,
        model,
        datamodule,
        optim_spec: OptimizerSpec,
        sched_spec: SchedulerSpec | None = None,
        criterion: Callable | None = None,
        tracker=None,
        checkpoint_cfg: dict | None = None,
        early_stop_cfg: dict | None = None,
        ckpt_path: str | None = None,
        callbacks: Sequence[Any] = (),
        swa_cfg: dict | None = None,
        pretrained_path: str | None = None,
    ) -> TrainState:
        t_fit = time.perf_counter()
        criterion = criterion or CrossEntropyLoss()
        datamodule.setup()
        pipeline = datamodule.pipeline
        num_classes = datamodule.num_classes
        swa = _SWA(**swa_cfg, max_epochs=self.max_epochs) if swa_cfg else None
        state = self.init_state(model, datamodule, optim_spec, sched_spec,
                                swa_lr_cfg=swa.lr_cfg if swa else None)
        if pretrained_path:
            state.model.load_state_dict(load_params(pretrained_path, state.model))
            print(f"Warm start: params loaded from {pretrained_path}")
        ckpt_cfg = dict(checkpoint_cfg or {})
        dirpath = ckpt_cfg.pop("dirpath", self.checkpoint_dir)
        if self.auto_resume and not ckpt_path:
            found = latest_checkpoint(dirpath)
            if found is not None:
                ckpt_path = found
                print(f"[auto-resume] newest checkpoint: {found}")
        if ckpt_path:
            restore_state(ckpt_path, state)
            print(f"Resumed from {ckpt_path} at step {state.step}")
        extras = MOE_METRICS if getattr(state.model, "config", {}).get("moe") else ()
        self._setup_device_data(datamodule)
        self._make_steps(pipeline, criterion)
        self.ckpt_manager = (
            CheckpointManager(dirpath, resume=bool(ckpt_path),
                              **{k: ckpt_cfg[k] for k in
                                 ("monitor", "mode", "save_top_k", "filename", "save_last")
                                 if k in ckpt_cfg})
            if self.enable_checkpointing else None)
        stopper = EarlyStopping(**early_stop_cfg) if early_stop_cfg else None

        spe = max(datamodule.steps_per_epoch, 1)
        log_every = self.log_every_n_steps or spe
        history: list[dict] = []
        epoch0 = state.step // spe
        stream = torch.cuda.current_stream(self.device) if self.device.type == "cuda" else None

        def to_device(batch):
            # on the prefetch thread: the copies go on the step's stream
            with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
                args, keep = self._step_args(batch, train=True)
            return args, keep, len(batch["label"])

        for epoch in range(epoch0, self.max_epochs):
            # ---- train ----
            ms = MT.MetricState.create(num_classes, self.device, extras)
            t0 = time.perf_counter()
            n_clips = 0
            it = (datamodule.train_index_batches(epoch=epoch, seed=self.seed)
                  if self._use_device_data
                  else datamodule.train_batches(epoch=epoch, seed=self.seed))
            prof_ctx = contextlib.nullcontext()
            if self.profile_dir and epoch == epoch0:
                from dlsc_tpu_torch.utils.profiling import trace

                prof_ctx = trace(self.profile_dir)
            with prof_ctx:
                batches = prefetch(it, to_device, size=2)
                for i, (args, _keep, n) in enumerate(batches):
                    if self.limit_train_batches and i >= self.limit_train_batches:
                        break
                    state, ms, loss = self._train_step(state, ms, *args)
                    n_clips += n
                    if tracker and (i + 1) % log_every == 0:
                        tracker.log_metric("train/loss_step", float(loss), state.step)
                batches.close()   # stop the prefetch thread now
                self._sync()
            dt = time.perf_counter() - t0
            metrics = {
                "train/acc": float(MT.accuracy(ms)),
                "train/loss": float(MT.mean_loss(ms)),
                "lr": float(state.lr_fn(state.step)),
                "perf/clips_per_sec_per_chip": n_clips / dt,
            }
            metrics.update({k: float(v) for k, v in ms.extra_means().items()})

            # ---- validate ----
            if (epoch + 1) % self.check_val_every_n_epoch == 0:
                vms = MT.MetricState.create(num_classes, self.device)
                vit = (datamodule.val_index_batches() if self._use_device_data
                       else datamodule.val_batches())
                for i, batch in enumerate(vit):
                    if self.limit_val_batches and i >= self.limit_val_batches:
                        break
                    args, _keep = self._step_args(batch, train=False)
                    vms, _ = self._eval_step(state, vms, *args)
                if int(vms.count) > 0:
                    metrics["val/acc"] = float(MT.accuracy(vms))
                    metrics["val/loss"] = float(MT.mean_loss(vms))

            self.logged_metrics = metrics
            history.append({"epoch": epoch, **metrics})
            if tracker:
                tracker.log_metrics(metrics, step=epoch)
            msg = " ".join(f"{k}={v:.4f}" for k, v in metrics.items())
            print(f"[epoch {epoch}] {msg}", flush=True)

            if self.ckpt_manager and "val/acc" in metrics:
                self.ckpt_manager.save(state, epoch, metrics)
                if self.ckpt_manager.save_last:
                    self.ckpt_manager.save_last_ckpt(state, epoch, metrics)
            for cb in callbacks:
                hook = getattr(cb, "on_validation_epoch_end", None)
                if hook:
                    hook(self, epoch, metrics)
            if swa:
                swa.update(epoch, state)
            if stopper and stopper.update(metrics):
                print(f"Early stopping at epoch {epoch} "
                      f"(best {stopper.monitor}={stopper.best:.4f})")
                break
            if self.should_stop:
                break

        if swa and swa.avg_params is not None:
            swa.apply(state.model)
            self._refresh_batch_stats(state, datamodule)
            print(f"SWA: averaged {swa.n_models} snapshots into final weights")

        self.state = state
        self.history = history
        if tracker and history:
            self._plot_curves(tracker, history)
        self.fit_seconds = time.perf_counter() - t_fit
        return state

    @torch.no_grad()
    def _refresh_batch_stats(self, state: TrainState, datamodule) -> None:
        """Re-estimate the BatchNorm statistics of SWA-averaged weights, as
        the JAX loop does: one train-mode pass over the train batches (epoch
        0's order, ``limit_train_batches``), each with the pipeline's train
        draws and a dropout seed from ``state.step_rng()``, the running
        statistics updated at momentum 0.9 and no parameter touched. A
        model without BatchNorm skips it. (``torch.optim.swa_utils.update_bn``
        would reset the statistics and take a cumulative mean instead.)"""
        model = state.model
        if not any(isinstance(m, torch.nn.modules.batchnorm._BatchNorm)
                   for m in model.modules()):
            return
        pipeline = datamodule.pipeline
        model.train()
        for i, batch in enumerate(datamodule.train_batches(epoch=0, seed=self.seed)):
            if self.limit_train_batches and i >= self.limit_train_batches:
                break
            wave = torch.as_tensor(batch["wave"], device=self.device)
            labels = torch.as_tensor(batch["label"], device=self.device)
            rng = state.step_rng()
            x, _ = pipeline.train_batch(wave, labels,
                                        pipeline.draw(len(labels), wave.shape[-1], rng))
            model(x, dropout_seed=int(rng.integers(2**62)))
        self._sync()

    # -- test ------------------------------------------------------------------
    def test(self, datamodule, state: TrainState | None = None,
             ckpt: str | Path | None = "best", criterion: Callable | None = None,
             tracker=None) -> dict:
        """Test-fold metrics of ``state`` (default: the fitted one). ``ckpt``
        'best' loads the best checkpoint of this trainer's fit into it, a
        path loads that checkpoint, None uses the state as it is."""
        criterion = criterion or CrossEntropyLoss()
        state = state or self.state
        if state is None:
            raise ValueError("call fit() first or pass a state")
        if ckpt == "best":
            if self.ckpt_manager and self.ckpt_manager.best_path:
                restore_state(self.ckpt_manager.best_path, state)
        elif ckpt:
            restore_state(ckpt, state)
        datamodule.setup()
        num_classes = datamodule.num_classes
        self._setup_device_data(datamodule)
        if self._eval_step is None:
            self._make_steps(datamodule.pipeline, criterion)
        ms = MT.MetricState.create(num_classes, self.device)
        all_probs, all_labels = [], []
        tit = (datamodule.test_index_batches() if self._use_device_data
               else datamodule.test_batches())
        for batch in tit:
            args, _keep = self._step_args(batch, train=False)
            ms, logits = self._eval_step(state, ms, *args)
            keep = batch["mask"]
            all_probs.append(torch.softmax(logits.float(), -1).cpu().numpy()[keep])
            all_labels.append(batch["label"][keep])
        probs = np.concatenate(all_probs)
        labels = np.concatenate(all_labels)
        confmat = ms.confmat.cpu().numpy()
        results = {
            "test/acc": float(MT.accuracy(ms)),
            "test/loss": float(MT.mean_loss(ms)),
            "test/f1": float(MT.macro_f1(ms)),
            "test/auroc": MT.macro_auroc(probs, labels, num_classes),
        }
        per_class = MT.per_class_accuracy(ms).cpu().numpy()
        if tracker:
            tracker.log_metrics(results)
            tracker.log_array(confmat, "test_confmat.npy")
            tracker.log_array(per_class, "test_class_acc.npy")
            self._plot_test_figures(tracker, confmat, per_class)
        results["confmat"] = confmat
        results["per_class_acc"] = per_class
        return results

    # -- figures (reference: engine.py:232-297); skipped without matplotlib ----
    def _plot_test_figures(self, tracker, confmat, per_class) -> None:
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return
        fig, ax = plt.subplots(figsize=(10, 10))
        ax.imshow(confmat, cmap="viridis")
        ax.set_xlabel("Predicted"); ax.set_ylabel("True"); ax.set_title("Confusion Matrix")
        tracker.log_figure(fig, "confmat.png"); plt.close(fig)

        fig, ax = plt.subplots(figsize=(12, 6))
        ax.bar(range(len(per_class)), per_class)
        ax.set_xlabel("Class Index"); ax.set_ylabel("Accuracy")
        ax.set_title("Per-Class Accuracy"); ax.set_ylim(0, 1)
        tracker.log_figure(fig, "per_class_accuracy.png"); plt.close(fig)

    def _plot_curves(self, tracker, history) -> None:
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return
        fig, ax = plt.subplots(figsize=(10, 6))
        epochs = [h["epoch"] for h in history]
        ax.plot(epochs, [h.get("train/acc") for h in history], label="Train Acc")
        if any("val/acc" in h for h in history):
            ax.plot(epochs, [h.get("val/acc") for h in history], label="Val Acc")
        ax.set_xlabel("Epoch"); ax.set_ylabel("Accuracy"); ax.set_ylim(0, 1)
        ax.set_title("Train/Val Accuracy per Epoch"); ax.legend()
        tracker.log_figure(fig, "train_val_accuracy.png"); plt.close(fig)


def with_window(make_model: Callable, model_kw: dict, window_samples: int) -> dict:
    """``model_kw`` with ``input_samples`` set to the pipeline's window when
    ``make_model`` takes that argument and ``model_kw`` leaves it unset: the
    port's EnvNet-v2 sizes its first dense layer from one input's length,
    which the Flax module infers from its first input. An explicit value wins."""
    if ("input_samples" in model_kw
            or "input_samples" not in inspect.signature(make_model).parameters):
        return model_kw
    return {**model_kw, "input_samples": int(window_samples)}


def build_from_cfg(cfg, pipeline_cfg: PipelineConfig) -> dict:
    """cfg → {model, criterion, optim_spec, sched_spec} (the reference's
    ``build_from_cfg``, engine.py:313-325). ``trainer.precision`` 32 builds
    the model in f32, 'bf16-mixed' and '16-mixed' in bf16 (as the JAX
    package does); its weights are a seeded init (``seed``). A model that
    takes ``input_samples`` (EnvNet-v2) gets the window of ``pipeline_cfg``
    (the datamodule's pipeline) unless the config sets it."""
    from dlsc_tpu_torch.config.instantiate import instantiate, resolve_target

    precision = str(cfg.select("trainer.precision", default="32"))
    dtype = torch.float32 if precision == "32" else torch.bfloat16
    model_cfg = cfg.model.to_dict()
    model_cfg.pop("dataset_overrides", None)
    model_cfg = with_window(resolve_target(model_cfg["_target_"]), model_cfg,
                            pipeline_cfg.window_samples)
    seed = int(cfg.select("seed", default=42))
    model = instantiate({**model_cfg, "dtype": dtype,
                         "generator": torch.Generator().manual_seed(seed)})
    criterion = instantiate(cfg.loss.to_dict()) if "loss" in cfg else CrossEntropyLoss()
    optim_spec = instantiate(cfg.optimizer.to_dict())
    sched_spec = instantiate(cfg.scheduler.to_dict()) if "scheduler" in cfg else None
    return {"model": model, "criterion": criterion, "optim_spec": optim_spec,
            "sched_spec": sched_spec}
