"""Export the serving artifact of one of the port's models.

    python -m dlsc_tpu_torch.scripts.export model=ast +out=exports/ast_torch \
        [+seed=0] [+params_npz=params.npz | +ckpt_path=<checkpoint dir>] [+batch=8] \
        [+clip_samples=220500] [+dtype=bfloat16]
    python -m dlsc_tpu_torch.scripts.export model=ast_moe +out=exports/ast_moe_torch
    python -m dlsc_tpu_torch.scripts.export model=ast_small +out=exports/ast_small_torch \
        [+model.ln_fused=true] [+model.attn_impl=flash]
    python -m dlsc_tpu_torch.scripts.export model=ast_mini +out=exports/ast_mini_torch
    python -m dlsc_tpu_torch.scripts.export model=ast +out=exports/ast_w8 +quant=w8 \
        [+ckpt_path=<dir>]   # int8 serving: +quant=w8a8 | w8 (ast, ast_small, ast_mini)
    python -m dlsc_tpu_torch.scripts.export model=envnet_v2 +out=exports/envnet_torch \
        +dtype=float32 [+model.dataset_overrides.preprocessing_config.multi_crop_test=true]
    python -m dlsc_tpu_torch.scripts.export model=cnn_esc50 +out=exports/cnn_torch +dtype=float32
    python -m dlsc_tpu_torch.scripts.export model=leaf +out=exports/leaf_torch +dtype=float32

Composes the same configs with the same override grammar as
``scripts/export.py`` and writes ``dlsc_tpu_torch.serving.export_model``'s
artifact. Weights come from ``+params_npz`` (a JAX ``params`` tree saved with
``np.savez``, keys joined by ``/``, e.g. ``blocks_0/attn/qkv/kernel``), from
``+ckpt_path`` (a checkpoint of ``dlsc_tpu_torch.scripts.train``, as
``scripts/export.py +ckpt_path`` takes one of ``scripts/train.py``) or,
without either, from a seeded init (``seed``; a smoke artifact). The model
comes from the config's ``_target_`` through the port's table
(``config/instantiate.py``): ``model=ast``, ``ast_moe``, ``ast_small``,
``ast_mini``, ``envnet_v2``, ``cnn_esc50`` and ``leaf``. Any model argument
goes through the override grammar, e.g. ``+model.ln_fused=true`` (kernel K3
in every block) or ``+model.attn_impl=flash``. ``+dtype`` defaults to
bfloat16, the AST family's serving dtype; the CNN families' configs train
in float32. EnvNet-v2 takes its input length from the eval pipeline's
window unless ``+model.input_samples`` sets it (``train/loop.with_window``).
Before writing, a CNN family's model runs one forward on the eval
pipeline's input from a silent clip (one crop of a multi-crop pipeline),
which checks that it takes what the pipeline gives it.

``+quant=w8a8|w8`` (``scripts/export.py:86-113``) rebuilds an AST-family
model in that int8 serving mode with remat off, loads the float weights and
materialises the int8 buffers from them (``ops/quant.py``); the manifest's
``quant`` names the mode and ``serving.load_exported`` rebuilds the model in
it. Another family, or AST-MoE, refuses it.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

from dlsc_tpu_torch.config import compose, resolve_target
from dlsc_tpu_torch.data.pipeline import pipeline_from_dataset_config
from dlsc_tpu_torch.models.layers import CNNBase
from dlsc_tpu_torch.models.vit import ASTViT, quantize_model
from dlsc_tpu_torch.scripts.train import parse_cli
from dlsc_tpu_torch.serving import export_model
from dlsc_tpu_torch.train.checkpoint import load_params
from dlsc_tpu_torch.train.loop import with_window


def main(argv: list[str] | None = None) -> Path:
    cfg = compose(*parse_cli(list(argv if argv is not None else sys.argv[1:])))
    out = cfg.select("out", default=None)
    if not out:
        raise SystemExit("pass +out=<artifact dir>")
    target = str(cfg.select("model._target_", default=""))
    try:
        make_model = resolve_target(target)
    except NotImplementedError as e:
        raise SystemExit(f"{e}; the port has model=ast, ast_moe, ast_small, ast_mini, "
                         "envnet_v2, cnn_esc50 and leaf")
    model_kw = cfg.model.to_dict()
    model_kw.pop("_target_")
    ds = cfg.dataset.to_dict()
    ds.update(model_kw.pop("dataset_overrides", None) or {})
    pipe = pipeline_from_dataset_config(ds)

    model_kw = with_window(make_model, model_kw, pipe.cfg.window_samples)
    seed = int(cfg.select("seed", default=0))
    model = make_model(**model_kw, dtype=str(cfg.select("dtype", default="bfloat16")),
                       generator=torch.Generator().manual_seed(seed))
    params_npz = cfg.select("params_npz", default=None)
    ckpt = cfg.select("ckpt_path", default=None)
    if params_npz or ckpt:
        model.load_state_dict(load_params(str(params_npz or ckpt), model))
    else:
        print(f"WARNING: exporting seeded random weights (seed {seed}, no "
              "+params_npz or +ckpt_path given) — smoke artifact only")
    quant = cfg.select("quant", default=None)
    if quant:
        if not isinstance(model, ASTViT):
            raise SystemExit(f"+quant={quant} is only supported by the ViT family "
                             f"(ast/ast_small/ast_mini), not {type(model).__name__}")
        model = quantize_model(model, str(quant))
    clip_samples = int(cfg.select("clip_samples", default=int(pipe.cfg.sample_rate * 5)))
    if isinstance(model, CNNBase):
        with torch.no_grad():
            x = pipe.eval_batch(torch.zeros(1, clip_samples))
            model.eval()(x[:, 0] if pipe.multi_crop else x)
    path = export_model(
        model, pipe, out,
        batch=int(cfg.select("batch", default=8)),
        clip_samples=clip_samples,
        meta={"model": target, "seed": seed,
              "params_npz": str(params_npz or ""), "ckpt_path": str(ckpt or ""),
              **({"quant": str(quant)} if quant else {})},
    )
    print(f"exported serving artifact: {path}")
    return path


if __name__ == "__main__":
    main()
