"""Faults and controls put in the program's place, to show that the
comparison that decides ``correct`` catches them (``calibrate.py`` on the
chip at the cell's own size, ``tests/`` on the CPU at a tiny one). Each is a
hook of ``run.execute``: {"ops": ...} options of the port's train step, or
{"serve": ...} a wrapper of the loaded serving function."""

from __future__ import annotations

import numpy as np
import torch


def misrouted_topk(every: int = 25):
    """A router that swaps its k-th choice for its (k+1)-th on every
    ``every``-th token (4% of them at 25), as a wrong tie-break or a wrong k
    on some rows would: the port's ``topk`` option of its train step."""

    def topk(gates: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
        v, i = torch.topk(gates, k + 1, dim=-1, sorted=True)
        pos = torch.arange(k + 1, device=gates.device)
        swap = torch.where(pos == k - 1, k, torch.where(pos == k, k - 1, pos))
        hit = torch.arange(gates.shape[-2], device=gates.device)[:, None] % every == 0
        order = torch.where(hit, swap, pos)[:, :k].expand(*v.shape[:-1], k)
        return v.gather(-1, order), i.gather(-1, order)

    return {"ops": {"topk": topk}}


def w8a8(dev):
    """The port's own int8 serving path (``quantize_model(..., "w8a8")``)
    put in place of the loaded bf16 model: the serving cell's control."""
    from dlsc_tpu_torch.models.vit import quantize_model
    from dlsc_tpu_torch.serving import make_infer

    def hook(serve_fn):
        infer = make_infer(quantize_model(serve_fn.model, "w8a8"), serve_fn.pipe)

        def call(wave):
            x = torch.as_tensor(np.asarray(wave)).to(dev)
            return infer(x).float().cpu().numpy()

        return call

    return {"serve": hook}
