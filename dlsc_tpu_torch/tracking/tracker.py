"""File-based experiment tracker.

The port's copy of ``dlsc_tpu/tracking/tracker.py`` (that module imports no
jax, but the port imports nothing of the JAX package). The reference logs
to MLflow (reference: scripts/train.py:126-167,
src/training/engine.py:223-283): flattened config params (250-char value
truncation), named metric time series, and figure/tensor artifacts. The
same surface is provided over a plain directory layout that
scripts/tracking_ui.py can browse:

    <root>/<experiment>/<run_id>/
        meta.json            (name, status, timestamps)
        params.json          (flattened config)
        metrics.jsonl        ({"name", "value", "step", "time"} per line)
        artifacts/           (figures, arrays, files)

Set DLSC_TRACKING_DIR to relocate the root (mirrors MLFLOW_TRACKING_URI).
"""

from __future__ import annotations

import json
import os
import time
import uuid
from pathlib import Path

import numpy as np

_MAX_PARAM_LEN = 250  # reference truncates values at 250 chars (train.py:150-156)


class Tracker:
    def __init__(
        self,
        experiment_name: str = "default",
        run_name: str | None = None,
        root: str | Path | None = None,
    ):
        root = Path(root or os.environ.get("DLSC_TRACKING_DIR", "runs"))
        self.run_id = time.strftime("%Y%m%d-%H%M%S") + "-" + uuid.uuid4().hex[:6]
        self.run_dir = root / experiment_name / self.run_id
        self.artifacts_dir = self.run_dir / "artifacts"
        self.artifacts_dir.mkdir(parents=True, exist_ok=True)
        self._metrics = open(self.run_dir / "metrics.jsonl", "a", buffering=1)
        self._meta = {
            "experiment": experiment_name,
            "run_name": run_name or self.run_id,
            "status": "RUNNING",
            "start_time": time.time(),
        }
        self._write_meta()

    def _write_meta(self) -> None:
        (self.run_dir / "meta.json").write_text(json.dumps(self._meta, indent=2))

    # -- params -----------------------------------------------------------
    def log_params(self, params: dict) -> None:
        clean = {
            str(k): (str(v)[:_MAX_PARAM_LEN] if v is not None else "None")
            for k, v in params.items()
        }
        path = self.run_dir / "params.json"
        existing = json.loads(path.read_text()) if path.exists() else {}
        existing.update(clean)
        path.write_text(json.dumps(existing, indent=2, sort_keys=True))

    # -- metrics ------------------------------------------------------------
    def log_metric(self, name: str, value, step: int | None = None) -> None:
        self._metrics.write(
            json.dumps(
                {"name": name, "value": float(value), "step": step, "time": time.time()}
            )
            + "\n"
        )

    def log_metrics(self, metrics: dict, step: int | None = None) -> None:
        for k, v in metrics.items():
            self.log_metric(k, v, step)

    # -- artifacts ------------------------------------------------------------
    def log_figure(self, fig, name: str) -> Path:
        path = self.artifacts_dir / name
        fig.savefig(path, bbox_inches="tight", dpi=120)
        return path

    def log_array(self, arr, name: str) -> Path:
        path = self.artifacts_dir / name
        np.save(path, np.asarray(arr))
        return path

    def log_text(self, text: str, name: str) -> Path:
        path = self.artifacts_dir / name
        path.write_text(text)
        return path

    def log_artifact(self, src: str | Path) -> Path:
        import shutil

        dst = self.artifacts_dir / Path(src).name
        shutil.copy2(src, dst)
        return dst

    # -- lifecycle ------------------------------------------------------------
    def finish(self, status: str = "FINISHED") -> None:
        self._meta["status"] = status
        self._meta["end_time"] = time.time()
        self._write_meta()
        self._metrics.close()


def load_metrics(run_dir: str | Path) -> list[dict]:
    path = Path(run_dir) / "metrics.jsonl"
    if not path.exists():
        return []
    return [json.loads(line) for line in path.read_text().splitlines() if line]
