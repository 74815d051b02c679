"""Train a sound-classification model with the port (the training entry point).

    python -m dlsc_tpu_torch.scripts.train model=ast dataset.root=<shards> \
        trainer.precision=bf16-mixed batch_size=64
    python -m dlsc_tpu_torch.scripts.train model=ast +ckpt_path=<run>/checkpoints/epoch-...
    python -m dlsc_tpu_torch.scripts.train model=ast +trainer.auto_resume=true \
        +checkpoint.save_last=true
    python -m dlsc_tpu_torch.scripts.train model=ast +pretrained_path=params.npz

Smoke run on the CPU (tiny model, few batches):

    python -m dlsc_tpu_torch.scripts.train model=ast trainer.accelerator=cpu \
        dataset.root=<shards> dataset.num_classes=10 +model.emb_dim=64 \
        +model.depth=2 +model.num_heads=2 trainer.max_epochs=2 batch_size=8 \
        +trainer.limit_train_batches=2 hydra.run.dir=<run dir>

Several devices: ``trainer.devices=N`` (``auto``: every visible GPU) starts
N ranks, one per device, and joins them (also a single rank, when a
multi-device layout is asked for on one device); under ``torchrun
--nproc-per-node N`` the script joins torchrun's group instead. On the CPU,
``trainer.accelerator=cpu trainer.devices=2`` runs two gloo ranks. Add
``+trainer.fsdp=true``, ``+trainer.expert_parallel=E`` or
``+trainer.pipeline_parallel=S`` (``+trainer.pp_microbatches=M``) for the
other layouts (``dlsc_tpu_torch/parallel``); ``batch_size`` is the global
batch. Rank 0 writes the checkpoints, the tracker and the output.

The same configs (``configs/``) and override grammar as ``scripts/train.py``,
and the same flow: compose → seed → datamodule from the dataset config and
the model's ``dataset_overrides`` → model, loss, optimizer and schedule from
the config (``train/loop.build_from_cfg``) → ``Trainer.fit`` (best
``val/acc`` checkpoints under ``<hydra.run.dir>/checkpoints``, early stop,
optional SWA) → ``Trainer.test`` on the best checkpoint → the ``test
results`` block. ``trainer.accelerator`` 'auto' runs on the GPU and fails
without one; ``trainer.accelerator=cpu`` runs on the CPU. Models:
``model=ast``, ``ast_small``, ``ast_mini``, ``ast_moe``, ``envnet_v2``,
``cnn_esc50`` and ``leaf``; EnvNet-v2's recipe is BC mixing (its config's
default) with ``loss._target_=torch.nn.KLDivLoss``. Make synthetic shards
with ``dlsc_tpu_torch.data.synthetic.make_synthetic_dataset``.
"""

from __future__ import annotations

import os
import random
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from dlsc_tpu_torch.config import compose, flatten, instantiate
from dlsc_tpu_torch.parallel.data import is_writer
from dlsc_tpu_torch.parallel.mesh import init_distributed, spawn
from dlsc_tpu_torch.tracking import Tracker
from dlsc_tpu_torch.train.loop import Trainer, build_from_cfg

CONFIG_DIR = Path(__file__).resolve().parents[2] / "configs"


def parse_cli(argv: list[str]) -> tuple[str, str, list[str]]:
    """``--config-path`` / ``--config-name`` and the overrides, as
    ``scripts/train.py`` parses them."""
    config_path, config_name = str(CONFIG_DIR), "training"
    overrides = []
    it = iter(argv)
    for a in it:
        if a == "--config-path":
            config_path = next(it)
        elif a == "--config-name":
            config_name = next(it)
        elif a in ("-h", "--help"):
            print(sys.modules["__main__"].__doc__ or __doc__)
            raise SystemExit(0)
        else:
            overrides.append(a)
    return config_path, config_name, overrides


def fix_seed(seed: int) -> None:
    """Python and numpy seeds (reference: train.py:44-50); the model's init
    and the step's draws have their own seeded generators."""
    random.seed(seed)
    np.random.seed(seed)


def build_datamodule(cfg):
    """The dataset config + top-level batch_size/num_workers + the model's
    ``dataset_overrides`` (popped from the model config, the reference's
    convention, train.py:91-107)."""
    ds_cfg = cfg.dataset.to_dict()
    ds_cfg["batch_size"] = cfg.select("batch_size", default=64)
    ds_cfg["num_workers"] = cfg.select("num_workers", default=0)
    overrides = cfg.model.pop("dataset_overrides", None)
    if overrides is not None:
        ds_cfg.update(overrides.to_dict() if hasattr(overrides, "to_dict") else dict(overrides))
    return instantiate(ds_cfg)


def run(cfg) -> dict:
    seed = int(cfg.select("seed", default=42))
    fix_seed(seed)
    run_dir = Path(cfg.select("hydra.run.dir", default="outputs/run"))
    run_dir.mkdir(parents=True, exist_ok=True)

    datamodule = build_datamodule(cfg)
    writer = is_writer()
    if writer:
        print(datamodule.summary())
    built = build_from_cfg(cfg, datamodule.pipeline.cfg)

    tracker = None
    if writer:
        tracker = Tracker(cfg.select("logging.experiment_name", default="training"))
        tracker.log_params({f"cfg_{k}": v for k, v in flatten(cfg.to_dict()).items()})

    ckpt_cfg = cfg.checkpoint.to_dict() if "checkpoint" in cfg else {}
    # a relative dirpath goes under the run dir (reference: callbacks.py:38-56)
    dirpath = Path(ckpt_cfg.pop("dirpath", "checkpoints"))
    if not dirpath.is_absolute():
        dirpath = run_dir / dirpath
    trainer = Trainer(**cfg.trainer.to_dict(), checkpoint_dir=dirpath, seed=seed)
    # optional SWA (reference: callbacks.py:71-79 gates on cfg.swa.enabled)
    swa_cfg = None
    if cfg.select("swa.enabled", default=False):
        swa_cfg = {k: v for k, v in cfg.swa.to_dict().items() if k != "enabled"}
    trainer.fit(
        built["model"], datamodule, built["optim_spec"], built["sched_spec"],
        criterion=built["criterion"], tracker=tracker,
        checkpoint_cfg=ckpt_cfg,
        early_stop_cfg=cfg.select("early_stop", default=None) and cfg.early_stop.to_dict(),
        ckpt_path=cfg.select("ckpt_path", default=None),
        swa_cfg=swa_cfg,
        pretrained_path=cfg.select("pretrained_path", default=None),
    )
    results = trainer.test(datamodule, criterion=built["criterion"], tracker=tracker)
    results["trainer"] = trainer
    if not writer:
        return results
    tracker.finish()

    print("\n=== test results ===")
    for k in ("test/acc", "test/f1", "test/auroc", "test/loss"):
        print(f"  {k}: {results[k]:.4f}")
    print(f"run dir: {run_dir}\ntracking: {tracker.run_dir}")
    if trainer.ckpt_manager and trainer.ckpt_manager.best_path:
        print(f"best checkpoint: {trainer.ckpt_manager.best_path}")
    return results


def n_ranks(cfg) -> tuple[int, str, bool]:
    """(the ranks that ``trainer.devices`` asks for, their device type,
    whether to start them: several, or one with a multi-device layout
    asked for, which then runs on a group of one)."""
    device_type = "cpu" if str(cfg.select("trainer.accelerator", default="auto")
                               ).lower() == "cpu" else "cuda"
    devices = cfg.select("trainer.devices", default="auto")
    if devices in ("auto", None):
        n = max(torch.cuda.device_count(), 1) if device_type == "cuda" else 1
    else:
        n = int(devices)
    layout = (bool(cfg.select("trainer.fsdp", default=False))
              or int(cfg.select("trainer.expert_parallel", default=1)) > 1
              or int(cfg.select("trainer.pipeline_parallel", default=1)) > 1)
    return n, device_type, n > 1 or layout


def _rank_main(config_path: str, config_name: str, overrides: list[str]) -> dict | None:
    """One spawned rank: the run; rank 0 returns its test metrics."""
    results = run(compose(config_path, config_name, overrides))
    if not is_writer():
        return None
    return {k: v for k, v in results.items() if k != "trainer"}


def main(argv: list[str] | None = None) -> dict:
    config_path, config_name, overrides = parse_cli(
        list(argv if argv is not None else sys.argv[1:]))
    cfg = compose(config_path, config_name, overrides)
    n, device_type, ranks = n_ranks(cfg)
    if not dist.is_initialized() and "RANK" in os.environ:   # under torchrun
        init_distributed(device_type=device_type)
    elif ranks and not dist.is_initialized():
        return spawn(_rank_main, n, config_path, config_name, overrides,
                     device_type=device_type, timeout_s=24 * 3600)[0]
    return run(cfg)


if __name__ == "__main__":
    main()
