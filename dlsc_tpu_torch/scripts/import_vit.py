"""Convert a timm/DeiT ViT ``.pth`` checkpoint into the port's pretrained
weights directory, applying the reference's AST init recipe.

    python -m dlsc_tpu_torch.scripts.import_vit --checkpoint deit_base_patch16_384.pth \
        --out pretrained/ast_base [--num-classes 50] [--audit] [--device cpu]

then train or export from it:

    python -m dlsc_tpu_torch.scripts.train model=ast +pretrained_path=pretrained/ast_base
    python -m dlsc_tpu_torch.scripts.export model=ast +ckpt_path=pretrained/ast_base \
        +out=exports/ast_w8 +quant=w8

The counterpart of ``scripts/import_vit.py``, with its options. The file is
read with ``torch.load(weights_only=True)``; a DeiT release's
``{"model": state_dict}`` (or ``{"state_dict": ...}``) wrapper, DDP
``module.`` prefixes and distilled variants are handled by
``models.ast.load_torch_vit``, which maps the weights onto an f32
``ASTModel`` of the given widths (its head from a seeded init). The output
is a ``train/checkpoint.save_params`` directory, which ``load_params``
reads (``+pretrained_path=``, ``+ckpt_path=``). Nothing is downloaded: the
``.pth`` must be on disk.

``--audit`` validates the checkpoint without writing anything: the key,
shape and transform report, then one forward of the converted model on a
zero input, which must be finite. That forward runs on ``--device``
(``cuda`` by default; ``cpu`` on request).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch

from dlsc_tpu_torch.models.ast import ASTModel, load_torch_vit
from dlsc_tpu_torch.train.checkpoint import save_params


def main(argv: list[str] | None = None) -> Path | None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoint", required=True, help="timm/DeiT .pth file")
    ap.add_argument("--out", required=True, help="output weights directory")
    ap.add_argument("--num-classes", type=int, default=50)
    ap.add_argument("--emb-dim", type=int, default=768)
    ap.add_argument("--depth", type=int, default=12)
    ap.add_argument("--num-heads", type=int, default=12)
    ap.add_argument("--sample-rate", type=int, default=44_100)
    ap.add_argument("--audit", action="store_true",
                    help="validate the checkpoint end to end (key, shape and transform "
                         "report, a finite forward) without writing the weights")
    ap.add_argument("--device", default="cuda",
                    help="where --audit's forward runs (default cuda; cpu on request)")
    args = ap.parse_args(argv)

    raw = torch.load(args.checkpoint, map_location="cpu", weights_only=True)
    for wrapper in ("model", "state_dict"):   # DeiT release files wrap the weights
        if isinstance(raw, dict) and isinstance(raw.get(wrapper), dict):
            raw = raw[wrapper]
            break
    model = ASTModel(num_classes=args.num_classes, emb_dim=args.emb_dim, depth=args.depth,
                     num_heads=args.num_heads, sample_rate=args.sample_rate,
                     dtype=torch.float32, generator=torch.Generator().manual_seed(0))
    audit: dict = {}
    model.load_state_dict(load_torch_vit(raw, model, audit=audit))
    if args.audit:
        print(f"== audit: {args.checkpoint} ==")
        print(f"source keys: {audit['n_source_keys']} (consumed {len(audit['consumed'])}, "
              f"ignored {len(audit['ignored'])}, leftover {len(audit['leftover'])})")
        for note in audit["notes"]:
            print(f"  transform: {note}")
        for key in audit["ignored"]:
            print(f"  ignored (head reinitialized for audio): {key}")
        if audit["leftover"]:
            print(f"  LEFTOVER (would fail strict load): {audit['leftover']}")
        print(f"target: {audit['n_target_leaves']} parameters, {audit['layout']} block layout "
              "— every mapped shape checked")
        device = torch.device(args.device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("import_vit --audit: device cuda requested but "
                               "torch.cuda.is_available() is False (pass --device cpu)")
        with torch.inference_mode():
            probs = model.to(device)(torch.zeros(1, 128, 128, device=device))
        finite = bool(torch.isfinite(probs).all())
        print(f"forward smoke (zeros input, {device.type}): finite={finite}, output shape "
              f"{tuple(probs.shape)}")
        if not finite:
            raise SystemExit("converted weights produce non-finite outputs")
        print("AUDIT OK — rerun without --audit to write the weights")
        return None
    out = save_params(args.out, model,
                      meta={"source": str(args.checkpoint), "num_classes": args.num_classes,
                            "emb_dim": args.emb_dim, "depth": args.depth})
    print(f"imported {len(raw)} torch tensors -> {out}")
    return out


if __name__ == "__main__":
    main()
