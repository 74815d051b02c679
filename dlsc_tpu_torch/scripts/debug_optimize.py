"""An observable HPO run with the port (the counterpart of
``scripts/debug_optimize.py``): the sweep of ``optimize_hyperparams`` with
a log line every 10 steps and 3 trials unless ``optuna.n_trials`` is given.

    python -m dlsc_tpu_torch.scripts.debug_optimize optuna.n_trials=3 trainer.max_epochs=5
"""

from __future__ import annotations

import sys

from dlsc_tpu_torch.scripts.optimize_hyperparams import build_runner, compose_cli


def main(argv: list[str] | None = None):
    cfg, overrides = compose_cli(list(argv if argv is not None else sys.argv[1:]))
    if "n_trials" not in " ".join(overrides):
        cfg.update("optuna.n_trials", 3)
    runner = build_runner(cfg, trainer_overrides={"enable_progress_bar": True,
                                                  "log_every_n_steps": 10})
    print(f"[debug] space: {runner.space.names()}")
    runner.optimize()
    print(runner.summary())
    return runner


if __name__ == "__main__":
    main()
