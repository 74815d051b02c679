"""Fold-wise evaluation with the port.

    # a checkpoint on its held-out fold
    python -m dlsc_tpu_torch.scripts.evaluate model=ast dataset.fold=0 \
        +ckpt_path=<run>/checkpoints/epoch-...

    # the official cross-validation: train + test on every fold
    python -m dlsc_tpu_torch.scripts.evaluate model=ast --cv

The counterpart of ``scripts/evaluate.py``, with the same config surface as
``dlsc_tpu_torch.scripts.train``. The CV mode prints per-fold top-1, F1 and
AUROC with their mean ± std and writes ``outputs/cv_report.json``
(``per_fold``, ``mean_acc``, ``std_acc``, ``n_folds``).
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

from dlsc_tpu_torch.config import compose
from dlsc_tpu_torch.scripts import train as train_script
from dlsc_tpu_torch.train.checkpoint import restore_state
from dlsc_tpu_torch.train.loop import Trainer, build_from_cfg


def evaluate_checkpoint(cfg) -> dict:
    ckpt_path = cfg.select("ckpt_path", default=None)
    if not ckpt_path:
        raise SystemExit("pass +ckpt_path=<checkpoint dir> (or use --cv)")
    datamodule = train_script.build_datamodule(cfg)
    built = build_from_cfg(cfg, datamodule.pipeline.cfg)
    trainer = Trainer(**cfg.trainer.to_dict(), enable_checkpointing=False,
                      seed=int(cfg.select("seed", default=42)))
    state = trainer.init_state(built["model"], datamodule, built["optim_spec"],
                               built["sched_spec"])
    restore_state(ckpt_path, state)
    trainer.state = state
    results = trainer.test(datamodule, state=state, ckpt=None, criterion=built["criterion"])
    print(f"fold {datamodule.fold}: "
          + " ".join(f"{k}={results[k]:.4f}" for k in ("test/acc", "test/f1", "test/auroc")))
    return results


def evaluate_cv(config_path: str, config_name: str, overrides: list[str]) -> dict:
    """Train + test on every official fold; aggregate."""
    probe = compose(config_path, config_name, overrides)
    n_folds = 10 if "urbansound" in str(probe.select("dataset.root", default="")) else 5
    per_fold = {}
    for fold in range(n_folds):
        cfg = compose(config_path, config_name, [*overrides, f"dataset.fold={fold}"])
        print(f"\n===== fold {fold}/{n_folds - 1} =====")
        results = train_script.run(cfg)
        per_fold[fold] = {k: float(results[k]) for k in
                          ("test/acc", "test/f1", "test/auroc", "test/loss")}
    accs = [v["test/acc"] for v in per_fold.values()]
    report = {
        "per_fold": per_fold,
        "mean_acc": float(np.mean(accs)),
        "std_acc": float(np.std(accs)),
        "n_folds": n_folds,
    }
    out = Path("outputs") / "cv_report.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2))
    print(f"\nCV top-1: {report['mean_acc']:.4f} ± {report['std_acc']:.4f} (report → {out})")
    return report


def main(argv: list[str] | None = None) -> dict:
    argv = list(argv if argv is not None else sys.argv[1:])
    cv = "--cv" in argv
    if cv:
        argv.remove("--cv")
    config_path, config_name, overrides = train_script.parse_cli(argv)
    if cv:
        return evaluate_cv(config_path, config_name, overrides)
    return evaluate_checkpoint(compose(config_path, config_name, overrides))


if __name__ == "__main__":
    main()
