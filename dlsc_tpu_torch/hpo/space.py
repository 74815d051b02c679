"""Hyperparameter search-space parsing from nested YAML.

The port's copy of ``dlsc_tpu/hpo/space.py``, on the port's ``Config``.

Reference semantics (src/optimization/hyperparameter_space.py):

- a nested mapping node is a *leaf distribution* iff it has a ``type:`` key
  (:52-77); the dotted path to the leaf is the parameter name,
- types: float (low/high/log), int (low/high/step), categorical (choices),
  discrete (choices alias) (:79-122),
- ``suggest_parameters(trial)`` → {dotted_name: value} (:124-171),
- ``update_config_with_params`` writes values back onto the config tree by
  dotted path (:173-199),
- modular loading: always ``training.yaml`` + ``loss.yaml`` plus
  ``models/{name}.yaml`` where name comes from the model ``_target_``
  (``*.models.X.Cls`` → ``X``) (:318-392).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

from dlsc_tpu_torch.config.core import Config

_LEAF_TYPES = {"float", "int", "categorical", "discrete"}


class HyperparameterSpace:
    def __init__(self, space: dict[str, dict]):
        """space: {dotted.param.name: distribution dict}."""
        self.space = space

    # -- parsing -----------------------------------------------------------
    @classmethod
    def from_nested(cls, tree: dict) -> "HyperparameterSpace":
        space: dict[str, dict] = {}

        def walk(node: Any, prefix: str) -> None:
            if isinstance(node, Config):
                node = node.to_dict()
            if not isinstance(node, dict):
                return
            if node.get("type") in _LEAF_TYPES:
                space[prefix] = dict(node)
                return
            for k, v in node.items():
                walk(v, f"{prefix}.{k}" if prefix
                     else str(k))

        walk(tree, "")
        return cls(space)

    @classmethod
    def from_model_config(
        cls,
        cfg,
        spaces_dir: str | Path = "configs/optimization/hyperparameter_spaces",
    ) -> "HyperparameterSpace":
        """training.yaml + loss.yaml + models/{model_name}.yaml."""
        spaces_dir = Path(spaces_dir)
        tree: dict = {}

        def load(p: Path):
            if p.exists():
                from dlsc_tpu_torch.config.compose import load_yaml

                _deep_merge(tree, load_yaml(p))

        load(spaces_dir / "training.yaml")
        load(spaces_dir / "loss.yaml")
        target = ""
        try:
            target = cfg.select("model._target_", default="") or ""
        except Exception:
            pass
        # "...models.<module>.<Cls>" → module name (reference :360-384);
        # fallback: the module right before the class name
        parts = target.split(".")
        name = ""
        if "models" in parts and parts.index("models") + 1 < len(parts):
            name = parts[parts.index("models") + 1]
        elif len(parts) >= 2:
            name = parts[-2]
        if name:
            load(spaces_dir / "models" / f"{name}.yaml")
        return cls.from_nested(tree)

    # -- sampling ------------------------------------------------------------
    def suggest_parameters(self, trial) -> dict[str, Any]:
        out = {}
        for name, dist in self.space.items():
            kind = dist["type"]
            if kind == "float":
                out[name] = trial.suggest_float(
                    name, float(dist["low"]), float(dist["high"]),
                    log=bool(dist.get("log", False)),
                    step=dist.get("step"),
                )
            elif kind == "int":
                out[name] = trial.suggest_int(
                    name, int(dist["low"]), int(dist["high"]),
                    log=bool(dist.get("log", False)),
                    step=int(dist.get("step", 1)),
                )
            elif kind in ("categorical", "discrete"):
                out[name] = trial.suggest_categorical(name, list(dist["choices"]))
            else:
                raise ValueError(f"unknown distribution type {kind!r} for {name}")
        return out

    # -- config patching --------------------------------------------------------
    @staticmethod
    def update_config_with_params(cfg: Config, params: dict[str, Any]) -> Config:
        for name, value in params.items():
            cfg.update(name, value)
        return cfg

    def __len__(self) -> int:
        return len(self.space)

    def names(self) -> list[str]:
        return list(self.space)


def _deep_merge(dst: dict, src: dict) -> None:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_merge(dst[k], v)
        else:
            dst[k] = v
