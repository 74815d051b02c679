"""Pipeline x tensor parallelism for the ViT encoder: dp x pp x tp.

Counterpart of ``dlsc_tpu/parallel/pp_tp.py``. JAX cannot put GSPMD's TP
shardings inside the pipeline's ``shard_map``, so it writes the block's
tensor parallelism by hand there, with two ``psum``s per block per
microbatch over 'model' and the row-parallel biases added once
(``pp_tp.py:146``, ``:163-180``). The port's tensor parallelism is written
by hand already (``tp.py``: two all-reduces per block, the proj and fc2
biases added after them, on every microbatch the stage runs), and its
pipeline (``pp.py``) runs the model's own blocks, so the two compose: on a
('data', 'stage', 'model') mesh each stage keeps its blocks and splits them
over its 'model' ranks; the ranks of one 'model' coordinate form the
pipeline, and the activations they pass are the replicated residual
stream. The batch is split over 'data' only.

MoE blocks split each expert's hidden dim over 'model' (``tp.py``), as
JAX's ``_block_tp`` does (wi and bi by columns, wo by rows, the router
replicated, bo divided by tp inside the sum), and so does ``tp.py``
outside the pipeline, where JAX's GSPMD tensor parallelism leaves the
experts replicated: the values are the same. The MoE aux loss is the
pipeline's estimator (``pp.py``), counted once over 'model'.

Dropout masks are the one-process draw's at the microbatch's rows and the
rank's heads and hidden units (a counter-based draw,
``ops/dropout_draw.py``), where JAX folds the 'model' index into the dense
hidden masks' keys and draws the experts' hidden masks with one key on
every 'model' rank.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from dlsc_tpu_torch.parallel.data import clip_shares_
from dlsc_tpu_torch.parallel.mesh import MeshPlan, world_size
from dlsc_tpu_torch.parallel.pp import Pipeline
from dlsc_tpu_torch.parallel.tp import TensorParallel
from torch.distributed.device_mesh import init_device_mesh


def get_pp_tp_mesh(n_devices: int | None = None, n_stages: int = 2, n_tp: int = 2,
                   device_type: str = "cuda") -> DeviceMesh:
    """The ('data', 'stage', 'model') mesh: batch x pipeline x tensor axes."""
    n = world_size() if n_devices is None else int(n_devices)
    if n != world_size() or n % (n_stages * n_tp):
        raise ValueError(f"{n} devices (the group has {world_size()}) not divisible by "
                         f"stage={n_stages}*model={n_tp}")
    return init_device_mesh(device_type, (n // (n_stages * n_tp), n_stages, n_tp),
                            mesh_dim_names=("data", "stage", "model"))


class PipelineTP(Pipeline):
    """GPipe over 'stage' with each stage's blocks split over 'model'."""

    def __init__(self, model: nn.Module, plan: MeshPlan, n_micro: int):
        super().__init__(model, plan, n_micro)
        self.tp = TensorParallel(model, plan.mesh, axis="model")
        # the replicated parameters: summed over the stages and data shards of
        # this 'model' coordinate, whose ranks computed them alike
        ranks = plan.mesh.mesh
        for m in range(ranks.shape[2]):
            group = dist.new_group(ranks[:, :, m].flatten().tolist())
            if m == plan.coordinate("model"):
                self.shared_group = group

    def sync_grads(self) -> None:
        self.tp.sync_grads()   # the MoE blocks' bo: partial over 'model'
        super().sync_grads()

    def clip_(self, max_norm: float) -> torch.Tensor:
        named = list(self.model.named_parameters())
        split = [p.grad for n, p in named if n in self.tp.split]
        blocks = [p.grad for n, p in named if n in self.block_names and n not in self.tp.split]
        shared = [p.grad for n, p in named if n not in self.block_names]
        return clip_shares_([(shared, None), (blocks, self.stage_group),
                             (split, (self.tp.group, self.stage_group))],
                            split + blocks + shared, max_norm)

    def _stage_state(self, state) -> tuple[dict, dict]:
        return self.tp.full_model_state(), self.tp.full_optimizer_by_name(state)

    def _cut(self, name: str, full: torch.Tensor) -> torch.Tensor:
        return self.tp.cut(name, full)
