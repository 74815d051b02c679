"""Rank functions of the multi-device tests (``tests/test_torch_parallel.py``,
``test_torch_ep_pp.py``, ``test_torch_dist_trainer.py``).

``dlsc_tpu_torch.parallel.mesh.spawn`` pickles these by import path into
fresh processes, so this module imports nothing of JAX: the ranks run the
port alone, on gloo process groups over the CPU. Inputs and results are
numpy arrays and Python values. Each function also runs in one process
(no group), which is the port at W = 1.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from dlsc_tpu_torch import parallel
from dlsc_tpu_torch.data.pipeline import DevicePipeline, PipelineConfig
from dlsc_tpu_torch.train import losses as L
from dlsc_tpu_torch.train import optim as O
from dlsc_tpu_torch.train.checkpoint import plain_state_dict
from dlsc_tpu_torch.train.metrics import MetricState
from dlsc_tpu_torch.train.state import TrainState
from dlsc_tpu_torch.train.steps import make_eval_step, make_train_step

CPU = torch.device("cpu")


def build_model(kind: str, kw: dict) -> torch.nn.Module:
    """A port model by name, with a seeded init (the tests load their own
    weights over it)."""
    from dlsc_tpu_torch.models.ast import ASTModel
    from dlsc_tpu_torch.models.ast_moe import ASTMoE
    from dlsc_tpu_torch.models.cnn_esc50 import CNN_ESC50
    from dlsc_tpu_torch.models.envnet_v2 import EnvNetV2
    from dlsc_tpu_torch.models.leaf import LeafModel
    from dlsc_tpu_torch.models.vit import ASTViT

    cls = {"ast": ASTModel, "vit": ASTViT, "ast_moe": ASTMoE, "envnet_v2": EnvNetV2,
           "cnn": CNN_ESC50, "leaf": LeafModel}[kind]
    return cls(**kw, generator=torch.Generator().manual_seed(0))


def _draws(spec: dict, pipe: DevicePipeline, n: int):
    """The global batch's draws of every step: given (``spec['draws']``, a
    list) or drawn from ``spec['draw_seed']`` (the same on every rank)."""
    if spec.get("draws") is not None:
        return spec["draws"]
    rng = np.random.default_rng(spec["draw_seed"])
    wave = spec["wave"]
    return [pipe.draw(wave.shape[0], wave.shape[-1], rng) for _ in range(n)]


def train_steps(spec: dict) -> dict:
    """``spec['steps']`` SGD train steps of a model on one global batch
    (``wave``, ``labels``), laid out as ``spec['layout']`` says ('ddp',
    'fsdp', 'ep', 'fsdp_ep' (experts over 2 ranks), 'pp', 'tp', 'sp',
    'pp_tp' (2 stages x 2 'model' ranks); anything at W = 1), from the weights
    ``spec['init']``. Returns the losses, the full state dict after the
    steps, the gradient of the first step (for SGD with lr 1 and no
    momentum, the change of the parameters) and the reduced confusion
    matrix, on rank 0 (None elsewhere)."""
    torch.manual_seed(0)
    model = build_model(spec["model"], spec["model_kw"])
    model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in spec["init"].items()})
    if spec.get("float64"):
        model.double()
        model.dtype = torch.float64
    layout_kind = spec.get("layout", "ddp")
    W = parallel.world_size()
    ep = {"ep": W, "fsdp_ep": 2}.get(layout_kind, 1)
    pp = W if layout_kind == "pp" else 1
    plan = parallel.make_plan("cpu", expert_parallel=ep, pipeline_parallel=pp)
    if layout_kind in ("tp", "sp") and dist.is_initialized():
        from dlsc_tpu_torch.parallel import tp

        layout = tp.tensor_parallel(model, parallel.get_mesh(W, W, "cpu"),
                                    sequence_parallel=layout_kind == "sp")
    elif layout_kind == "pp_tp" and dist.is_initialized():
        from dlsc_tpu_torch.parallel import pp_tp

        layout = pp_tp.PipelineTP(model, parallel.MeshPlan(pp_tp.get_pp_tp_mesh(W, 2, 2, "cpu")),
                                  spec["n_micro"])
    else:
        layout = parallel.make_layout(model, plan, CPU, fsdp=layout_kind in ("fsdp", "fsdp_ep"),
                                      expert_parallel=ep, pipeline_parallel=pp,
                                      n_micro=spec.get("n_micro"))
    pipe = DevicePipeline(PipelineConfig(**spec["pipe"]))
    crit = L.KLDivLoss() if spec.get("loss") == "kl" else L.CrossEntropyLoss()
    name, opt_kw = spec.get("opt", ("sgd", dict(lr=1.0)))
    sched = spec.get("cosine_t_max")
    state = TrainState.create(model, getattr(O, name)(**opt_kw),
                              None if sched is None else O.cosine_annealing(T_max=sched), 1,
                              gradient_clip_val=spec.get("clip"))
    state.parallel = layout
    step = make_train_step(pipe, crit, spec.get("accum", 1))
    ms = MetricState.create(spec["pipe"]["num_classes"], CPU,
                            spec.get("extras", ()))
    wave = torch.from_numpy(spec["wave"])
    labels = torch.from_numpy(spec["labels"])
    draws = _draws(spec, pipe, spec["steps"])
    seeds = spec.get("dropout_seeds") or [None] * spec["steps"]
    losses, sds = [], []
    for i in range(spec["steps"]):
        state, ms, loss = step(state, ms, wave, labels, draws[i], seeds[i])
        losses.append(float(loss))
        sds.append(_full_model(state, layout, layout_kind))
    if layout is not None:
        ms = layout.reduce_metrics(ms)
    if dist.is_initialized() and dist.get_rank() != 0:
        return None
    return {"loss": losses, "params": sds,
            "confmat": ms.confmat.numpy(),
            "extras": {k: float(v) for k, v in ms.extra_means().items()}}


def mesh_facts(spec: dict) -> dict | None:
    """What the ranks' (data, model) mesh plans say, and the mesh errors."""
    plan = parallel.make_plan("cpu")
    rows = [None] * parallel.world_size()
    dist.all_gather_object(rows, plan.rows(8))
    t = torch.tensor([float(dist.get_rank() + 1)])
    parallel.replicate([t])   # rank 0's value everywhere
    out = {"rows": rows, "pad": plan.pad_batch(13), "n_data": plan.n_data,
           "shard": parallel.shard_batch({"x": np.arange(8)}, plan)["x"].tolist(),
           "replicated": t.item()}
    for key, fn in (("mp_error", lambda: parallel.get_mesh(2, 3, "cpu")),
                    ("rows_error", lambda: plan.rows(7))):
        try:
            fn()
        except ValueError as e:
            out[key] = str(e)
    return out if dist.get_rank() == 0 else None


def run_all(specs: list[dict]) -> list:
    """Each spec's function (``spec['fn']``, default ``train_steps``), in one
    process group: the checks of a test file share one spawn. A rank uses
    one intra-op thread: the test workers and the ranks share the host's
    cores."""
    if dist.is_initialized():
        torch.set_num_threads(1)
    return [globals()[spec.get("fn", "train_steps")](spec) for spec in specs]


def _full_model(state, layout, kind) -> dict | None:
    """The full model state dict (numpy) on rank 0."""
    if kind in ("tp", "sp") and layout is not None:
        sd = layout.full_model_state()   # every rank gathers; rank 0 returns it
        sd = sd if dist.get_rank() == 0 else None
    elif layout is not None:
        full = layout.full_state(state)
        sd = None if full is None else full["model"]
    else:
        sd = plain_state_dict(state)["model"]
    return None if sd is None else {k: v.numpy().copy() for k, v in sd.items()}


def eval_logits(spec: dict) -> dict | None:
    """The eval step on one global batch (``wave``, ``labels``, ``mask``):
    the reduced metric state and the global logits, on rank 0."""
    model = build_model(spec["model"], spec["model_kw"])
    model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in spec["init"].items()})
    plan = parallel.make_plan("cpu")
    layout = parallel.make_layout(model, plan, CPU, fsdp=spec.get("layout") == "fsdp")
    pipe = DevicePipeline(PipelineConfig(**spec["pipe"]))
    state = TrainState.create(model, O.sgd(lr=1.0), None, 1)
    state.parallel = layout
    ms = MetricState.create(spec["pipe"]["num_classes"], CPU)
    ms, logits = make_eval_step(pipe, L.CrossEntropyLoss())(
        state, ms, torch.from_numpy(spec["wave"]), torch.from_numpy(spec["labels"]),
        torch.from_numpy(spec["mask"]))
    if layout is not None:
        logits = layout.gather_rows(logits, len(spec["mask"]))
        ms = layout.reduce_metrics(ms)
    if dist.is_initialized() and dist.get_rank() != 0:
        return None
    return {"logits": logits.numpy(), "confmat": ms.confmat.numpy(),
            "loss_sum": float(ms.loss_sum), "count": int(ms.count)}


def fit(spec: dict) -> dict | None:
    """``Trainer.fit`` and ``test`` of a small AST on the shards under
    ``spec['root']`` with the Trainer's options ``spec['trainer']``, from
    the weights ``spec['npz']``; rank 0 returns the history, the test
    results, the best and last checkpoints and the full final weights."""
    from dlsc_tpu_torch.data.datamodule import ESC50DataModule
    from dlsc_tpu_torch.models.ast import ASTModel
    from dlsc_tpu_torch.train.loop import Trainer

    trainer = Trainer(accelerator="cpu", seed=0, **spec["trainer"])
    model = ASTModel(**spec["model_kw"], dtype=torch.float32)
    dm = ESC50DataModule(root=spec["root"], **spec["dm"])
    state = trainer.fit(model, dm, O.sgd(lr=spec["lr"]), O.cosine_annealing(T_max=4),
                        criterion=L.CrossEntropyLoss(), checkpoint_cfg=dict(spec["ckpt"]),
                        pretrained_path=spec["npz"])
    results = trainer.test(dm, criterion=L.CrossEntropyLoss())
    full = state.parallel.full_state(state)
    if not dist.get_rank() == 0:
        return None
    return {"history": trainer.history, "results": {k: v for k, v in results.items()},
            "best": str(trainer.ckpt_manager.best_path),
            "model": {k: v.numpy().copy() for k, v in full["model"].items()},
            "layout": type(state.parallel).__name__}


def option_error(spec: dict) -> str | None:
    """The message of the ValueError that ``Trainer(**spec['trainer']).fit``
    raises on a model (at W ranks), on rank 0."""
    from dlsc_tpu_torch.data.datamodule import ESC50DataModule
    from dlsc_tpu_torch.models.ast import ASTModel
    from dlsc_tpu_torch.train.loop import Trainer

    try:
        trainer = Trainer(accelerator="cpu", seed=0, **spec["trainer"])
        trainer.fit(ASTModel(**spec["model_kw"], dtype=torch.float32),
                    ESC50DataModule(root=spec["root"], **spec["dm"]), O.sgd(lr=0.1))
    except ValueError as e:
        return str(e) if dist.get_rank() == 0 else None
    raise AssertionError("no ValueError")


def vmapped_study(spec: dict) -> dict:
    """A vmapped study of a tiny ViT (per-trial dropout and mixup α) on the
    shards under ``spec['root']``: ``run_batch(k)`` (``spec['mode']`` 'batch')
    or ``run_continuous(k, spec['total'])``; in a process group its K trials
    split over the ranks (``VmappedTrialRunner(plan=...)``), the study on
    rank 0. Every rank returns what the runner returned and its own trials'
    stacked states; rank 0 also the study's trials (or ``spec['k']``'s
    refusal, when ``spec['refusal']``)."""
    from dlsc_tpu_torch import hpo
    from dlsc_tpu_torch.data.datamodule import ESC50DataModule
    from dlsc_tpu_torch.hpo.hyperband import HyperbandPruner
    from dlsc_tpu_torch.hpo.vmapped import VmappedTrialRunner
    from dlsc_tpu_torch.models.vit import ASTViT

    lead = not dist.is_initialized() or dist.get_rank() == 0
    dm = ESC50DataModule(root=spec["root"], **spec["dm"])
    study = hpo.Study(spec["name"], spec["db"], "maximize", sampler=hpo.TPESampler(seed=3),
                      pruner=HyperbandPruner(min_resource=1, max_resource=2,
                                             reduction_factor=2)) if lead else None
    plan = parallel.make_plan("cpu") if dist.is_initialized() else None
    runner = VmappedTrialRunner(study, ASTViT(**spec["model_kw"]), dm.pipeline, dm, epochs=2,
                                seed=3, device="cpu", do_space={"low": 0.0, "high": 0.5},
                                ma_space={"low": 0.2, "high": 2.0}, plan=plan)
    if spec.get("refusal"):
        try:
            runner.run_batch(k=spec["k"])
        except ValueError as e:
            return str(e)
        raise AssertionError("no ValueError")
    out = {}
    if spec["mode"] == "batch":
        res = runner.run_batch(k=spec["k"])
        st = res.states
        out = dict(history=res.history, values=res.values, numbers=res.trial_numbers,
                   flat=st.flat.numpy().copy(), mu=st.mu.numpy().copy(),
                   nu=st.nu.numpy().copy(), count=st.count.numpy().copy(),
                   buffers={k: v.numpy().copy() for k, v in st.buffers.items()})
    else:
        fin = runner.run_continuous(k=spec["k"], total_trials=spec["total"])
        out = dict(finished=[(t.number, t.params, t.state, t.value) for t in fin])
    if lead:
        out["trials"] = [(t.number, t.params, t.state, t.value, t.intermediate_values)
                         for t in study.trials]
    return out


def tp_error(spec: dict) -> str | None:
    """The message of the ValueError that ``tensor_parallel`` raises on a
    tiny AST-MoE whose experts are split over the ranks (``spec['case']``
    'ep'), or whose expert hidden dim the ranks do not divide ('hidden'),
    on rank 0."""
    from dlsc_tpu_torch.parallel import tp
    from dlsc_tpu_torch.parallel.ep import ExpertSharding, shard_experts

    model = build_model("vit", spec["model_kw"])
    W = dist.get_world_size()
    if spec["case"] == "ep":
        shard_experts(model, ExpertSharding(dist.group.WORLD, dist.get_rank(), W))
    else:
        moe = model.blocks[0].moe
        moe.wi = torch.nn.Parameter(moe.wi.data[..., :-1].contiguous())
    try:
        tp.tensor_parallel(model, parallel.get_mesh(W, W, "cpu"))
    except ValueError as e:
        return str(e) if dist.get_rank() == 0 else None
    raise AssertionError("no ValueError")
