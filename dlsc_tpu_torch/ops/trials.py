"""Helpers of the kernel ops' ``torch.func.vmap`` rules (the vmapped HPO
step, ``hpo/vmapped.py``): the trial axis moved first, and operands the
CUDA kernels can take."""

from __future__ import annotations

import torch


def trial_major(info, in_dims, *ts: torch.Tensor) -> list[torch.Tensor]:
    """``ts`` under a vmap level, each with the trial axis first (an
    unbatched one expanded to it)."""
    return [t.movedim(d, 0) if d is not None else t.expand(info.batch_size, *t.shape)
            for t, d in zip(ts, in_dims)]


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and starting on 16 bytes, as the kernels load it (a
    trial's parameters are a view into the stacked state at any offset),
    copied only where it is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()
