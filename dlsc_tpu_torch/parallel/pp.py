"""Pipeline parallelism for the ViT encoder: GPipe over 'stage' ranks.

Counterpart of ``dlsc_tpu/parallel/pp.py`` (``shard_map`` over a 'stage'
axis, ``ppermute`` hops, ``n_micro + S - 1`` ticks). Stage s of S holds the
blocks [s·L/S, (s+1)·L/S) (the others are dropped from its model); the
embed, the final norm and the head are on every stage, as JAX replicates
them over 'stage', and are used by the first and the last stage.

The schedule is GPipe, written with ``torch.distributed`` ``send``/``recv``
by hand rather than ``torch.distributed.pipelining``: the stage's forward
is the model's own ``ASTViT.run_block`` (its remat policy, its kernels,
its per-block dropout seeds), a microbatch's tokens are one tensor of a
shape every stage knows, and the MoE aux loss is a second output of a
stage's forward, which ``pipelining``'s stage module does not carry. Every
microbatch goes forward through all the stages (stage s receives from
s - 1, runs its blocks, sends to s + 1; the last computes the head and the
loss), then backward in reverse order (the last stage's loss, the others'
received output gradients). The bubble is (S-1)/(M+S-1) of a step, as in
JAX; the stages idle where JAX's compute masked garbage.

Semantics, against the JAX pipeline:

- a microbatch's dropout masks are the global batch's at its rows, keyed
  by the sequential model's (seed, block) (a counter-based draw,
  ``ops/dropout_draw.py``: a microbatch computes its own rows' bits only):
  the pipelined step draws what the one-process step draws (JAX folds a
  key from (data shard, microbatch, layer) instead, ``pp.py:290-300``);
- the MoE aux loss is JAX's estimator: each (microbatch, stage) computes
  its layers' aux over the microbatch's rows, and the loss adds their sum
  over the stages divided by ``n_micro`` (``pp.py:212-215``), then the
  mean over the data ranks; the MoE stats are not reported, as in JAX;
- the model's remat policy is honoured (``pp.py:342-347``);
- gradients: a block's are averaged over the 'data' ranks of its stage;
  the replicated parameters' (embed, norm, head) are summed over the
  stages, which hold them in turn, and averaged over 'data';
- checkpoints gather every stage's blocks into the full state dict.
"""

from __future__ import annotations

import inspect

import torch
import torch.distributed as dist
from torch import nn

from dlsc_tpu_torch.parallel.data import (Layout, clip_shares_, is_writer, optimizer_by_name,
                                          optimizer_by_name_from, optimizer_from_names,
                                          set_batch_group, sum_grads)
from dlsc_tpu_torch.parallel.mesh import MeshPlan, get_mesh


def check_batch(batch_size: int, n_data: int, n_micro: int) -> None:
    """GPipe's divisibility (``dlsc_tpu/train/loop.py:468-474``)."""
    if batch_size % (n_data * n_micro):
        raise ValueError(f"batch_size={batch_size} must be divisible by data-parallel degree "
                         f"({n_data}) × pp_microbatches ({n_micro}) = {n_data * n_micro}")


def get_pp_mesh(n_devices: int | None = None, n_stages: int = 2, device_type: str = "cuda"):
    """The ('data', 'stage') mesh: batch axis x pipeline axis."""
    return get_mesh(n_devices, n_stages, device_type, axes=("data", "stage"))


class Pipeline(Layout):
    """GPipe over the mesh's 'stage' axis (see the module docstring)."""

    runs_step = True

    def __init__(self, model: nn.Module, plan: MeshPlan, n_micro: int):
        super().__init__(model, plan)
        if not hasattr(model, "blocks"):
            raise ValueError("trainer.pipeline_parallel supports the ViT (AST) model family — "
                             "the encoder block stack is what gets staged; "
                             f"{type(model).__name__} has no block stack")
        S, s = plan.size("stage"), plan.coordinate("stage")
        depth = len(model.blocks)
        if depth % S:
            raise ValueError(f"model depth {depth} not divisible by pipeline_parallel={S}")
        if model.token_shard is not None:
            raise ValueError("pipeline parallelism does not compose with sequence "
                             "parallelism; build the model without token sharding")
        self.S, self.s, self.n_micro = S, s, n_micro
        per = depth // S
        self.own = range(s * per, (s + 1) * per)
        for i in range(depth):
            if i not in self.own:
                model.blocks[i] = nn.Identity()
        set_batch_group(model, None)   # MoE aux: per microbatch, as JAX estimates it
        self.stage_group = plan.mesh.get_group("stage")
        self.data_group = plan.mesh.get_group("data")
        # the ranks that hold the replicated parameters' gradients in turn
        self.shared_group = dist.group.WORLD
        ranks = dist.get_process_group_ranks(self.stage_group)
        self.prev = ranks[s - 1] if s > 0 else None
        self.next = ranks[s + 1] if s < S - 1 else None
        self.last = ranks[-1]
        self.block_names = {n for n, _ in model.named_parameters() if n.startswith("blocks.")}
        # the model's own ops, as ASTViT.forward defaults them
        defaults = inspect.signature(type(model).forward).parameters
        self.ops = {k: defaults[k].default
                    for k in ("attention", "grouped_matmul", "topk", "add_ln")}

    # -- the schedule ----------------------------------------------------------
    def _tokens(self, x: torch.Tensor) -> tuple[torch.Tensor | None, int, tuple]:
        """Stage 0: the embedded tokens; every stage: n_real and the token
        tensor's shape and dtype (the embed of no rows)."""
        model = self.model
        tok, n_real = model.embed(x if self.s == 0 else x[:0])
        return (tok if self.s == 0 else None), n_real, (tuple(tok.shape[1:]), tok.dtype)

    def _stage(self, h: torch.Tensor, n_real: int, seed, rows, ops) -> tuple:
        model = self.model
        op = {**self.ops, **ops}
        aux = None
        for i in self.own:
            h, a, _ = model.run_block(i, h, n_real, op["attention"], op["grouped_matmul"],
                                      op["topk"], seed, op["add_ln"], rows)
            if a is not None:
                aux = a if aux is None else aux + a
        return h, aux

    def train_micro(self, pipeline, criterion, wave, labels, draws, seed, accum, ops):
        """One accumulation micro-batch (the global batch ``wave``): this
        rank's rows through the GPipe schedule, gradients accumulated with
        weight 1/accum. Returns (loss, logits, soft labels, {}) of the
        rank's rows, the same on every stage."""
        B = wave.shape[0]
        lo, hi = self.plan.rows(B)
        M = self.n_micro
        check_batch(B, self.plan.n_data, M)
        x, y = pipeline.train_batch_rows(wave, labels, draws, lo, hi)
        mb = (hi - lo) // M
        model = self.model
        seed = model.dropout_seed(seed)
        saved = []
        for m in range(M):
            xm = x[m * mb:(m + 1) * mb]
            tok, n_real, (shape, dt) = self._tokens(xm)
            if self.s == 0:
                h_in = tok
            else:
                h_in = torch.empty((mb,) + shape, dtype=dt, device=x.device)
                dist.recv(h_in, self.prev)
                h_in.requires_grad_()
            h, aux = self._stage(h_in, n_real, seed, (lo + m * mb, B), ops)
            out = None
            if self.next is not None:
                dist.send(h.detach().contiguous(), self.next)
            else:
                out = model.finalize(h)
            saved.append((h_in, h, aux, out))
        ce = []
        for m in reversed(range(M)):
            h_in, h, aux, out = saved[m]
            terms, grads = [], []
            if out is not None:
                loss_m = criterion(out, y[m * mb:(m + 1) * mb])
                ce.append(loss_m.detach())
                terms.append(loss_m / (M * accum))
                grads.append(None)
            else:
                g = torch.empty_like(h)
                dist.recv(g, self.next)
                terms.append(h)
                grads.append(g)
            if aux is not None:
                terms.append(aux / (M * accum))
                grads.append(None)
            torch.autograd.backward(terms, grads)
            if self.prev is not None:
                dist.send(h_in.grad.contiguous(), self.prev)
        # the rank's logits and CE from the last stage, the stages' aux summed
        if self.next is None:
            logits = torch.cat([out for *_, out in saved]).detach()
            ce_mean = torch.stack(ce).mean()
        else:
            logits = torch.empty((hi - lo, y.shape[1]), dtype=torch.float32, device=x.device)
            ce_mean = x.new_zeros(())
        aux_sum = sum((aux.detach() for _, _, aux, _ in saved if aux is not None),
                      x.new_zeros(())) / M
        dist.broadcast(logits, self.last, group=self.stage_group)
        dist.broadcast(ce_mean, self.last, group=self.stage_group)
        dist.all_reduce(aux_sum, group=self.stage_group)
        return ce_mean + aux_sum, logits, y, {}

    @torch.no_grad()
    def eval_forward(self, pipeline, x: torch.Tensor) -> torch.Tensor:
        """Logits of the rank's rows (eval mode, the whole batch at once),
        the same on every stage."""
        tok, n_real, (shape, dt) = self._tokens(x)
        if self.s == 0:
            h = tok
        else:
            h = torch.empty((x.shape[0],) + shape, dtype=dt, device=x.device)
            dist.recv(h, self.prev)
        h, _ = self._stage(h, n_real, None, None, {})
        if self.next is not None:
            dist.send(h.contiguous(), self.next)
            logits = torch.empty((x.shape[0], self.model.head.out_features),
                                 dtype=torch.float32, device=x.device)
        else:
            logits = self.model.finalize(h)
        dist.broadcast(logits, self.last, group=self.stage_group)
        return logits

    # -- gradients, clipping, checkpoints --------------------------------------
    def _split(self):
        named = list(self.model.named_parameters())
        return ([p for n, p in named if n in self.block_names],
                [p for n, p in named if n not in self.block_names])

    def sync_grads(self) -> None:
        blocks, shared = self._split()
        inv = 1.0 / self.plan.n_data
        sum_grads(shared, self.shared_group, inv)
        sum_grads(blocks, self.data_group, inv)

    def clip_(self, max_norm: float) -> torch.Tensor:
        blocks, shared = self._split()
        gb, gs = [p.grad for p in blocks], [p.grad for p in shared]
        return clip_shares_([(gs, None), (gb, self.stage_group)], gb + gs, max_norm)

    def _stage_state(self, state) -> tuple[dict, dict]:
        """This stage's model state dict and optimizer state by name, on the
        CPU, whole (``pp_tp.py`` merges its 'model' shards here)."""
        from dlsc_tpu_torch.train.checkpoint import _to_cpu

        return (_to_cpu(self.model.state_dict()),
                _to_cpu(optimizer_by_name(state.optimizer, self.local_names)))

    def _cut(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's part of a whole parameter or moment (all of it here)."""
        return full

    def full_state(self, state) -> dict | None:
        model, by_name = self._stage_state(state)
        mine = ({k: v for k, v in model.items() if k.startswith("blocks.")},
                {k: v for k, v in by_name["state"].items() if k in self.block_names})
        parts = [None] * self.S
        dist.all_gather_object(parts, mine, group=self.stage_group)
        for blocks, moments in parts:
            model.update(blocks)
            by_name["state"].update(moments)
        if not is_writer():
            return None
        return {"model": model, "optimizer": optimizer_from_names(by_name, self.full_names),
                "step": int(state.step), "generator": state.generator.get_state()}

    def load_model_state(self, sd: dict) -> None:
        own = self.model.state_dict()
        self.model.load_state_dict({k: self._cut(k, sd[k]) for k in own})

    def load_state(self, state, ck: dict) -> None:
        self.load_model_state(ck["model"])
        by_name = optimizer_by_name_from(ck["optimizer"], self.full_names)
        names = self.local_names
        by_name["state"] = {n: {k: self._cut(n, v) if v.ndim > 0 else v for k, v in st.items()}
                            for n, st in by_name["state"].items() if n in names}
        state.optimizer.load_state_dict(optimizer_from_names(by_name, names))
        state.step = int(ck["step"])
        state.generator.set_state(ck["generator"])

