"""Export the AST or AST-MoE serving artifact of the port.

    python -m dlsc_tpu_torch.scripts.export model=ast +out=exports/ast_torch \
        [+seed=0] [+params_npz=params.npz] [+batch=8] [+clip_samples=220500] \
        [+dtype=bfloat16]
    python -m dlsc_tpu_torch.scripts.export model=ast_moe +out=exports/ast_moe_torch

Composes the same configs with the same override grammar as
``scripts/export.py`` and writes ``dlsc_tpu_torch.serving.export_model``'s
artifact. Weights come from ``+params_npz`` (a JAX ``params`` tree saved with
``np.savez``, keys joined by ``/``, e.g. ``blocks_0/attn/qkv/kernel``) or,
without it, from a seeded init (``seed``; a smoke artifact).
``model=ast`` and ``model=ast_moe`` are ported (ROADMAP §1 M7 for the other
families).
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

from dlsc_tpu_torch.config import compose
from dlsc_tpu_torch.data.pipeline import pipeline_from_dataset_config
from dlsc_tpu_torch.models.ast import ASTModel
from dlsc_tpu_torch.models.ast_moe import ASTMoE
from dlsc_tpu_torch.models.convert import params_from_jax
from dlsc_tpu_torch.serving import export_model

CONFIG_DIR = Path(__file__).resolve().parents[2] / "configs"
MODELS = {"ast.ASTModel": ASTModel, "ast_moe.ASTMoE": ASTMoE}   # by _target_ suffix


def parse_cli(argv: list[str]) -> tuple[str, str, list[str]]:
    """``--config-path`` / ``--config-name`` and overrides, as scripts/train.py
    parses them (that module imports jax, so the port keeps its own copy)."""
    config_path, config_name = str(CONFIG_DIR), "training"
    overrides = []
    it = iter(argv)
    for a in it:
        if a == "--config-path":
            config_path = next(it)
        elif a == "--config-name":
            config_name = next(it)
        elif a in ("-h", "--help"):
            print(__doc__)
            raise SystemExit(0)
        else:
            overrides.append(a)
    return config_path, config_name, overrides


def _unflatten(npz) -> dict:
    tree: dict = {}
    for key in npz.files:
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = npz[key]
    return tree


def main(argv: list[str] | None = None) -> Path:
    cfg = compose(*parse_cli(list(argv if argv is not None else sys.argv[1:])))
    out = cfg.select("out", default=None)
    if not out:
        raise SystemExit("pass +out=<artifact dir>")
    target = str(cfg.select("model._target_", default=""))
    make_model = next((m for suffix, m in MODELS.items() if target.endswith(suffix)), None)
    if make_model is None:
        raise SystemExit(f"model {target!r} is not ported yet; only model=ast and "
                         "model=ast_moe (ROADMAP §1 M7 for the other families)")
    model_kw = cfg.model.to_dict()
    model_kw.pop("_target_")
    ds = cfg.dataset.to_dict()
    ds.update(model_kw.pop("dataset_overrides", None) or {})
    pipe = pipeline_from_dataset_config(ds)

    seed = int(cfg.select("seed", default=0))
    model = make_model(**model_kw, dtype=str(cfg.select("dtype", default="bfloat16")),
                       generator=torch.Generator().manual_seed(seed))
    params_npz = cfg.select("params_npz", default=None)
    if params_npz:
        with np.load(str(params_npz)) as npz:
            model.load_state_dict(params_from_jax(_unflatten(npz), model))
    else:
        print(f"WARNING: exporting seeded random weights (seed {seed}, no "
              "+params_npz given) — smoke artifact only")
    path = export_model(
        model, pipe, out,
        batch=int(cfg.select("batch", default=8)),
        clip_samples=int(cfg.select(
            "clip_samples", default=int(pipe.cfg.sample_rate * 5))),
        meta={"model": target, "seed": seed,
              "params_npz": str(params_npz or "")},
    )
    print(f"exported serving artifact: {path}")
    return path


if __name__ == "__main__":
    main()
