"""Vmapped multi-trial HPO: K hyperparameter trials trained in lockstep on
one card, each step one ``torch.func.vmap`` over the trials.

The port of ``dlsc_tpu/hpo/vmapped.py``. Trials of the *same architecture*
that differ only in continuous hyperparameters (learning rate, weight
decay, label smoothing, dropout rate, mixup α, the schedule's shape) share
every forward and backward: one launch of each kernel serves all K.

Mechanics:

- the K trials' parameters are one (K, P) f32 tensor (``TrialStates.flat``;
  ``TrialStates.params`` are its per-parameter views), their buffers
  (BatchNorm statistics, ``hyper_rate``) stacked (K, ...) tensors, their
  Adam moments two more (K, P) tensors;
- a step runs ``vmap(grad_and_value(loss))`` over the stacked parameters
  and buffers through ``torch.func.functional_call`` of the one model; each
  trial draws its own dropout masks from its own seed, made from the step's
  seed and the trial's global slot index (``ops.dropout_draw.trial_seeds``:
  a counter-based draw, so a trial's masks do not depend on which trials
  share its step or its rank, as JAX's per-trial keys, ``split(key(seed),
  k)``), and no op in the step draws from torch's generators
  (``randomness='error'``);
  the kernel ops register vmap rules that fold the trial axis into their
  batch (``ops/attn_fast.py``, ``ops/gmm.py``; ``ops/ln_fused.py``
  launches once a trial where γ and β are per trial), and BatchNorm updates
  the stacked statistics in place;
- the per-trial optimiser (``_make_injected_tx`` there) runs on the stacked
  tensors: clip each trial's gradient by its own global norm, torch-style
  L2 (``wd · p`` added to the gradient), Adam, then scale by −lr ·
  ``schedule_factor`` of that trial's step count, with lr, weight decay,
  T_max and warmup (K,) tensors;
- per-trial parameter inits and random streams come from explicit seeds
  (``jax.random`` streams cannot be matched: tests replay the draws);
- the data stream is shared across trials (lockstep epochs), and the
  per-epoch validation accuracies go to the Study, so TPE and Hyperband see
  the same evidence as sequential trials.

Two deviations from the JAX runner, neither changing a value:

- **K1 outside vmap.** Before SpecAugment the mel features of the shared
  batch are the same for every trial; the JAX runner computes them K times
  inside ``jax.vmap``, the port once, outside the vmap
  (``DevicePipeline.train_batch_trials``), and each trial's SpecAugment and
  Mixup draws apply to that one tensor.
- **No remat.** ``torch.utils.checkpoint`` runs on saved-tensor hooks,
  which ``torch.func.grad`` does not support, so the vmapped step runs the
  model with ``remat`` off (the JAX runner keeps the model's remat).

Trials over several ranks (``plan``, the JAX runner's ``plan=``,
``:196``, ``:363-397``): the K trials are split over the plan's 'data'
ranks, K / W a rank (K must be a multiple of W), with the batch replicated:
every rank walks the same batches and draws the same step seeds; rank r
trains the trials of the global slots [r·K/W, (r+1)·K/W), whose inits,
pipeline draws and dropout seeds are keyed by the global slot as on one
process. No collective runs inside the step. Rank 0 alone holds the study:
it asks and tells, and broadcasts the hyperparameters (and, when a slot is
recycled, its new trial's); every rank's per-trial accuracies are gathered
for the reports and the pruning, whose decisions rank 0 broadcasts. Every
rank returns the global history, values and trial numbers; ``states`` holds
its own trials.

Two execution modes:

- ``run_batch(k)``: one fixed batch of K trials for ``epochs`` epochs.
  Pruned trials keep computing (their slots are marked).
- ``run_continuous(k, total_trials)``: **slot recycling**: when a trial is
  pruned or finishes its epoch budget, slot i of the stacked parameters,
  buffers and optimiser state is written with a fresh suggestion's init.
  K stays constant, so nothing is rebuilt.

The model must follow the port's forward contract, ``model(x,
dropout_seed=..., return_aux=True) -> (outputs, aux loss, stats)``, and
have a seeded init (``_init_weights(gen)``, the AST family, or
``_init(gen)``, the CNN families).
"""

from __future__ import annotations

import copy
import dataclasses
import math

import numpy as np
import torch
from torch.func import functional_call, grad_and_value, vmap

from dlsc_tpu_torch.hpo.study import Study, Trial, TrialState
from dlsc_tpu_torch.ops.dropout_draw import trial_seeds
from dlsc_tpu_torch.parallel.mesh import MeshPlan, broadcast_object, gather_objects
from dlsc_tpu_torch.train.losses import CrossEntropyLoss

VMAPPABLE = ("optimizer.lr", "optimizer.weight_decay", "loss.label_smoothing",
             "model.dropout", "dataset.mixup_alpha",
             "scheduler.T_max", "scheduler.warmup_frac")
# What fans out across lockstep slots (the JAX package's frontier):
# - optimizer.lr / optimizer.weight_decay / the schedule's T_max and warmup
#   ride in the stacked optimiser state ((K,) tensors);
# - loss.label_smoothing is applied to each trial's targets;
# - model.dropout is each MLP's ``hyper_rate`` buffer, stacked (K,): needs a
#   model with the ``hyper_dropout`` option (the ViT family);
# - dataset.mixup_alpha is each trial's Beta parameter, drawn on the host
#   from that trial's stream: needs a pipeline with enable_mixup.
# What cannot fan out (it changes the program, not a value in it): the
# optimiser family, the scheduler family, architecture dims, batch size,
# preprocessing mode. Those go through the sequential runner
# (hpo/runner.py), which shares the same Study.

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8   # optax scale_by_adam's defaults


def schedule_factor(count, t_max_steps, warmup_steps) -> torch.Tensor:
    """Warmup + cosine LR multiplier at Adam step ``count`` (f32 tensors,
    any broadcastable shapes).

    Linear 0→1 over ``warmup_steps``, then cosine 1→0 over the remaining
    ``t_max_steps - warmup_steps``; ``t_max_steps == 0`` means no schedule
    (constant 1.0).
    """
    c = torch.as_tensor(count, dtype=torch.float32)
    t_max = torch.as_tensor(t_max_steps, dtype=torch.float32)
    warm = torch.as_tensor(warmup_steps, dtype=torch.float32)
    one = torch.ones((), dtype=torch.float32)
    warm_f = torch.where(warm > 0, torch.minimum(c / torch.clamp(warm, min=1.0), one), one)
    prog = torch.clamp((c - warm) / torch.clamp(t_max - warm, min=1.0), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return torch.where(t_max > 0, warm_f * cos, one)


def _slot_seed(seed: int, n: int) -> int:
    """The init seed of a trial: slot n of the first batch, or 1000 + the
    trial's count for a recycled slot (the JAX runner's fold_in)."""
    return int(np.random.SeedSequence([seed, n]).generate_state(1, np.uint64)[0] >> 1)


@dataclasses.dataclass
class TrialStates:
    """K trials' training state, stacked on a leading trial axis."""

    flat: torch.Tensor                 # (K, P) f32 parameters
    shapes: list[tuple[str, tuple[int, ...]]]
    buffers: dict[str, torch.Tensor]   # (K, ...)
    mu: torch.Tensor                   # (K, P) Adam moments
    nu: torch.Tensor
    count: torch.Tensor                # (K,) int32 Adam steps
    hyper: dict[str, torch.Tensor]     # 'lr', 'wd', 'tm', 'wu': (K,) f32
    rngs: list[np.random.Generator]    # each trial's pipeline draws

    @property
    def k(self) -> int:
        return self.flat.shape[0]

    @property
    def params(self) -> dict[str, torch.Tensor]:
        """{name: (K, *shape) view of ``flat``}: writing a view writes the state."""
        out, off = {}, 0
        for name, shape in self.shapes:
            n = math.prod(shape)
            out[name] = self.flat[:, off:off + n].view(self.k, *shape)
            off += n
        return out

    def scatter(self, other: "TrialStates", i: int) -> None:
        """Write the one trial of ``other`` into slot ``i``, in place."""
        self.flat[i] = other.flat[0]
        self.mu[i] = other.mu[0]
        self.nu[i] = other.nu[0]
        self.count[i] = other.count[0]
        for name, b in self.buffers.items():
            b[i] = other.buffers[name][0]
        for name, h in self.hyper.items():
            h[i] = other.hyper[name][0]
        self.rngs[i] = other.rngs[0]


class TrialMetrics:
    """K trials' streaming confusion matrices, (K, C, C) int64 ([true, pred])."""

    def __init__(self, k: int, num_classes: int, device: torch.device):
        self.confmat = torch.zeros((k, num_classes, num_classes), dtype=torch.int64,
                                   device=device)

    @torch.no_grad()
    def update(self, logits: torch.Tensor, hard: torch.Tensor,
               mask: torch.Tensor | None = None) -> "TrialMetrics":
        """``logits`` (K, B, C); ``hard`` labels (K, B) or (B,) shared."""
        K, B, C = logits.shape
        hard = hard.expand(K, B).long()
        valid = (torch.ones((K, B), dtype=torch.int64, device=logits.device) if mask is None
                 else mask.to(logits.device, torch.int64).expand(K, B))
        trial = torch.arange(K, device=logits.device)[:, None]
        idx = (trial * C + hard) * C + logits.argmax(-1)
        self.confmat.view(-1).index_add_(0, idx.reshape(-1), valid.reshape(-1))
        return self

    def accuracy(self) -> np.ndarray:
        """Micro top-1 of each trial, (K,)."""
        cm = self.confmat
        acc = cm.diagonal(dim1=1, dim2=2).sum(-1) / cm.sum((1, 2)).clamp_min(1)
        return acc.double().cpu().numpy()


def _reinit(model: torch.nn.Module, gen: torch.Generator) -> None:
    """The model's seeded init, in place (the AST family's or the CNNs')."""
    init = getattr(model, "_init_weights", None) or getattr(model, "_init", None)
    if init is None:
        raise ValueError(f"{type(model).__name__} has no seeded init (_init_weights or _init)")
    with torch.no_grad():
        init(gen)


@torch.no_grad()
def adam_step_(st: TrialStates, g: torch.Tensor, clip: float | None) -> None:
    """One optimiser step of every trial, in place, from the stacked
    gradients ``g`` (K, P): the chain of ``_make_injected_tx``
    (``dlsc_tpu/hpo/vmapped.py:113-142``) with each trial's own values:
    clip by the trial's global norm (optax: g / norm · clip at norm >=
    clip), L2 (g + wd · p), Adam (optax ``scale_by_adam``: bias-corrected
    moments, eps outside the root), then · −lr · ``schedule_factor`` at the
    trial's step count before this step."""
    if clip:
        norm = g.square().sum(1, keepdim=True).sqrt()
        g = torch.where(norm < clip, g, g / norm * clip)
    g = g + st.hyper["wd"][:, None] * st.flat
    lr = st.hyper["lr"] * schedule_factor(st.count, st.hyper["tm"], st.hyper["wu"])
    st.mu.mul_(ADAM_B1).add_((1 - ADAM_B1) * g)
    st.nu.mul_(ADAM_B2).add_((1 - ADAM_B2) * g.square())
    st.count += 1
    c = st.count.float()[:, None]
    mu_hat = st.mu / (1 - ADAM_B1 ** c)
    nu_hat = st.nu / (1 - ADAM_B2 ** c)
    st.flat.add_(-(mu_hat / (nu_hat.sqrt() + ADAM_EPS)) * lr[:, None])


@dataclasses.dataclass
class VmappedResult:
    trial_numbers: list[int]
    values: list[float]
    states: TrialStates    # this rank's trials
    history: list[dict]


class VmappedTrialRunner:
    def __init__(
        self,
        study: Study | None,
        model: torch.nn.Module,
        pipeline,
        datamodule,
        *,
        epochs: int = 10,
        lr_space: dict | None = None,
        wd_space: dict | None = None,
        ls_space: dict | None = None,
        do_space: dict | None = None,    # model.dropout: needs hyper_dropout
        ma_space: dict | None = None,    # dataset.mixup_alpha: needs enable_mixup
        tmax_space: dict | None = None,  # scheduler.T_max in epochs (int), to steps
        wu_space: dict | None = None,    # scheduler.warmup_frac of T_max
        gradient_clip_val: float | None = 1.0,
        min_epochs: int = 0,
        seed: int = 0,
        device: torch.device | str | None = None,
        plan: MeshPlan | None = None,
    ):
        """``model``: the template (its weights are re-initialised per trial);
        ``device``: where the trials train (default ``cuda``; the CPU only
        when asked); ``plan``: the trials split over its 'data' ranks (the
        module docstring), ``study`` then on its rank 0 (None elsewhere)."""
        self.study = study
        if do_space is not None:
            if "hyper_dropout" not in getattr(model, "config", {}):
                raise ValueError(
                    "do_space (per-trial dropout) needs a model with the "
                    f"hyper_dropout hook (the ViT family); "
                    f"{type(model).__name__} has none")
            model = type(model)(**{**model.config, "hyper_dropout": True})
        if ma_space is not None:
            if not pipeline.cfg.enable_mixup:
                raise ValueError(
                    "ma_space (per-trial mixup alpha) needs a pipeline with "
                    "enable_mixup=True")
            if float(ma_space["low"]) <= 0:
                raise ValueError(
                    "ma_space.low must be > 0: a traced Beta alpha cannot "
                    "take the alpha<=0 'mixup off' escape (ops/augment.mixup)")
        if wu_space is not None and tmax_space is None:
            raise ValueError(
                "wu_space (warmup fraction) needs tmax_space: warmup is a "
                "fraction of the cosine period")
        self.model = model
        self.pipeline = pipeline
        self.datamodule = datamodule
        self.epochs = epochs
        self.lr_space = lr_space or {"type": "float", "low": 1e-5, "high": 1e-2,
                                     "log": True}
        self.wd_space = wd_space or {"type": "float", "low": 1e-6, "high": 1e-2,
                                     "log": True}
        self.ls_space = ls_space  # None → label smoothing not searched
        self.do_space = do_space  # None → dropout not searched
        self.ma_space = ma_space  # None → mixup alpha not searched
        self.tmax_space = tmax_space  # None → no schedule (constant lr)
        self.wu_space = wu_space      # None → no warmup
        self.gradient_clip_val = gradient_clip_val
        self.min_epochs = min_epochs
        self.seed = seed
        self.device = torch.device("cuda" if device is None else device)
        self.plan = plan
        self.n_ranks = 1 if plan is None else plan.n_data
        self.rank = 0 if plan is None else plan.coordinate("data")
        self.group = None if plan is None else plan.group("data")
        self.slot0 = 0   # the global slot of this rank's first trial

    # -- the ranks ------------------------------------------------------------------
    def _check_k(self, k: int) -> None:
        if k % self.n_ranks:
            raise ValueError(
                f"k={k} trials must be a multiple of the mesh data axis "
                f"({self.n_ranks}) for mesh-sharded trial parallelism")

    def _share(self, obj):
        """Rank 0's ``obj`` on every rank."""
        return obj if self.group is None else broadcast_object(obj, self.group)

    def _gathered(self, local: np.ndarray) -> np.ndarray:
        """The ranks' per-trial values, in global slot order."""
        return local if self.group is None else np.concatenate(
            gather_objects(local, self.group))

    def _ask_shared(self, k: int) -> tuple[list[Trial | None], dict[str, np.ndarray],
                                           list[int]]:
        """K trials asked on rank 0: (the trials there, [None] * K elsewhere;
        the hyperparameter columns and the trial numbers on every rank)."""
        trials, hp = self._ask_batch(k) if self.rank == 0 else (None, None)
        numbers, hp = self._share((trials and [t.number for t in trials], hp))
        return trials or [None] * k, hp, numbers

    # -- trial batch construction ------------------------------------------------
    def _ask_batch(self, k: int) -> tuple[list[Trial], dict[str, np.ndarray]]:
        """Ask K trials; returns the per-slot hyperparameter arrays keyed
        'lr', 'wd', 'ls', 'do', 'ma', 'tm' (T_max, steps), 'wu' (warmup,
        steps)."""
        spe = self.datamodule.steps_per_epoch
        trials = []
        cols: dict[str, list] = {n: [] for n in
                                 ("lr", "wd", "ls", "do", "ma", "tm", "wu")}
        for _ in range(k):
            t = self.study.ask()
            cols["lr"].append(
                t.suggest_float("optimizer.lr", self.lr_space["low"],
                                self.lr_space["high"],
                                log=self.lr_space.get("log", True)))
            cols["wd"].append(
                t.suggest_float("optimizer.weight_decay",
                                self.wd_space["low"], self.wd_space["high"],
                                log=self.wd_space.get("log", True)))
            cols["ls"].append(
                t.suggest_float("loss.label_smoothing", self.ls_space["low"],
                                self.ls_space["high"])
                if self.ls_space else 0.0)
            cols["do"].append(
                t.suggest_float("model.dropout", self.do_space["low"],
                                self.do_space["high"])
                if self.do_space else 0.0)
            cols["ma"].append(
                t.suggest_float("dataset.mixup_alpha", self.ma_space["low"],
                                self.ma_space["high"],
                                log=self.ma_space.get("log", False))
                if self.ma_space else 1.0)  # unused when not searched (> 0)
            if self.tmax_space:
                tm_epochs = t.suggest_int(
                    "scheduler.T_max", int(self.tmax_space["low"]),
                    int(self.tmax_space["high"]))
                tm = float(tm_epochs * spe)
                wu = (t.suggest_float("scheduler.warmup_frac",
                                      self.wu_space["low"],
                                      self.wu_space["high"]) * tm
                      if self.wu_space else 0.0)
            else:
                tm, wu = 0.0, 0.0  # schedule off (constant lr)
            cols["tm"].append(tm)
            cols["wu"].append(wu)
            trials.append(t)
        return trials, {n: np.asarray(v, np.float32)
                        for n, v in cols.items()}

    # -- shared execution machinery ---------------------------------------------
    def _build_exec(self) -> dict:
        """The init, train, eval and accuracy functions (K-agnostic):

        - ``init_one(seed, lr, wd, do, tm, wu)``, ``init_v(seeds, lr, wd, do,
          tm, wu)`` → ``TrialStates`` of 1 or len(seeds) trials;
        - ``train(states, ms, ls, ma, wave, labels, draws=None,
          dropout_seed=None)`` → (states, ms, loss (K,)): one lockstep step,
          states updated in place; ``draws`` (one per trial, the pipeline's
          ``draw``) default to the trials' own streams, ``dropout_seed`` (the
          step's, from which each trial's is made by its global slot,
          ``slot0`` onwards) to the run's stream;
        - ``eval(states, ms, wave, labels, mask)`` → (ms, logits (K, B, C));
        - ``acc(ms)`` → (K,) accuracies.
        """
        dm = self.datamodule
        dm.setup()
        dev = self.device
        runner = self
        pipe = self.pipeline
        template = copy.deepcopy(self.model).cpu()   # re-initialised once a trial
        names = [n for n, _ in template.named_parameters()]
        shapes = [(n, tuple(p.shape)) for n, p in template.named_parameters()]
        buffers0 = {n: b.detach().clone() for n, b in template.named_buffers()}
        # the module functional_call runs, every parameter and buffer handed in
        model = self.model.to(dev)
        model.remat = False   # checkpoint's saved-tensor hooks do not compose with grad
        hyper_names = [n for n in buffers0 if n.endswith("hyper_rate")]
        crit = CrossEntropyLoss()   # smoothing is applied to each trial's targets
        clip = float(self.gradient_clip_val) if self.gradient_clip_val else None
        search_alpha = self.ma_space is not None
        run_rng = np.random.default_rng(np.random.SeedSequence([self.seed, 3]))

        def init_v(seeds, lr, wd, do, tm, wu) -> TrialStates:
            rows, bufs, rngs = [], {n: [] for n in buffers0}, []
            for seed, rate in zip(seeds, np.asarray(do, np.float32).reshape(-1)):
                _reinit(template, torch.Generator().manual_seed(int(seed)))
                rows.append(torch.cat([p.detach().reshape(-1).float()
                                       for p in template.parameters()]))
                for n, b0 in buffers0.items():
                    bufs[n].append(torch.full_like(b0, float(rate)) if n in hyper_names
                                   else b0)
                rngs.append(np.random.default_rng(np.random.SeedSequence([int(seed), 2])))
            flat = torch.stack(rows).to(dev)

            def col(v):
                return torch.as_tensor(np.asarray(v, np.float32).reshape(-1), device=dev)

            return TrialStates(
                flat=flat, shapes=shapes,
                buffers={n: torch.stack(v).to(dev) for n, v in bufs.items()},
                mu=torch.zeros_like(flat), nu=torch.zeros_like(flat),
                count=torch.zeros(flat.shape[0], dtype=torch.int32, device=dev),
                hyper={"lr": col(lr), "wd": col(wd), "tm": col(tm), "wu": col(wu)},
                rngs=rngs)

        def init_one(seed, lr, wd, do, tm, wu) -> TrialStates:
            return init_v([seed], [lr], [wd], [do], [tm], [wu])

        def loss_one(params, buffers, x, y, seed):
            out, aux, _ = functional_call(model, (params, buffers), (x,),
                                          {"dropout_seed": seed, "return_aux": True})
            return crit(out, y) + aux, out

        def step_grads(params, buffers, xs, ys, seeds):
            return vmap(grad_and_value(loss_one, has_aux=True), randomness="error")(
                params, buffers, xs, ys, seeds)

        def train(st: TrialStates, ms: TrialMetrics, ls, ma, wave, labels, draws=None,
                  dropout_seed=None):
            wave = torch.as_tensor(wave).to(dev)
            labels = torch.as_tensor(labels).to(dev)
            ma = np.asarray(ma, np.float32).reshape(-1)
            if draws is None:
                draws = [pipe.draw(wave.shape[0], wave.shape[-1], rng,
                                   float(ma[i]) if search_alpha else None)
                         for i, rng in enumerate(st.rngs)]
            if dropout_seed is None:
                dropout_seed = int(run_rng.integers(2**62))
            xs, ys = pipe.train_batch_trials(wave, labels, draws)
            ls_t = torch.as_tensor(np.asarray(ls, np.float32).reshape(-1, 1, 1), device=dev)
            ys_s = ys * (1.0 - ls_t) + ls_t / ys.shape[-1]
            model.train()
            seeds = trial_seeds(int(dropout_seed), range(runner.slot0, runner.slot0 + st.k))
            grads, (loss, logits) = step_grads(st.params, st.buffers, xs, ys_s, seeds)
            adam_step_(st, torch.cat([grads[n].reshape(st.k, -1).float() for n in names], 1),
                       clip)
            ms.update(logits.detach(), ys.argmax(-1))
            return st, ms, loss.detach()

        @torch.no_grad()
        def evaluate(st: TrialStates, ms: TrialMetrics, wave, labels, mask):
            wave = torch.as_tensor(wave).to(dev)
            x = pipe.eval_batch(wave)
            model.eval()
            logits = vmap(lambda p, b: pipe.forward_eval(
                lambda inp: functional_call(model, (p, b), (inp,)), x))(st.params, st.buffers)
            ms.update(logits, torch.as_tensor(labels).to(dev), torch.as_tensor(mask))
            return ms, logits

        return {"init_one": init_one, "init_v": init_v, "train": train,
                "eval": evaluate, "acc": TrialMetrics.accuracy}

    def _metrics(self, k: int) -> TrialMetrics:
        return TrialMetrics(k, self.datamodule.num_classes, self.device)

    def _epoch(self, fns: dict, states: TrialStates, ls_arr, ma_arr, epoch: int
               ) -> tuple[np.ndarray, np.ndarray]:
        """One lockstep epoch and the validation pass: (val accs, train accs)
        of every trial, gathered over the ranks."""
        ms = self._metrics(states.k)
        for batch in self.datamodule.train_batches(epoch=epoch, seed=self.seed):
            fns["train"](states, ms, ls_arr, ma_arr, batch["wave"], batch["label"])
        vms = self._metrics(states.k)
        for batch in self.datamodule.val_batches():
            fns["eval"](states, vms, batch["wave"], batch["label"], batch["mask"])
        return self._gathered(fns["acc"](vms)), self._gathered(fns["acc"](ms))

    def _init_states(self, fns: dict, hp: dict) -> TrialStates:
        """This rank's trials: the global slots [slot0, slot0 + K / W)."""
        k = len(hp["lr"]) // self.n_ranks
        self.slot0 = self.rank * k
        mine = slice(self.slot0, self.slot0 + k)
        return fns["init_v"]([_slot_seed(self.seed, i) for i in range(mine.start, mine.stop)],
                             *(hp[n][mine] for n in ("lr", "wd", "do", "tm", "wu")))

    # -- lockstep training ------------------------------------------------------
    def run_batch(self, k: int = 8) -> VmappedResult:
        self._check_k(k)
        fns = self._build_exec()
        trials, hp, numbers = self._ask_shared(k)
        states = self._init_states(fns, hp)
        mine = slice(self.slot0, self.slot0 + states.k)
        ls_arr, ma_arr = hp["ls"][mine], hp["ma"][mine]

        pruned = [False] * k
        history = []
        for epoch in range(self.epochs):
            val_accs, train_accs = self._epoch(fns, states, ls_arr, ma_arr, epoch)
            history.append({"epoch": epoch, "val_acc": val_accs.tolist(),
                            "train_acc": train_accs.tolist()})
            if self.rank == 0:
                for i, t in enumerate(trials):
                    if pruned[i]:
                        continue
                    t.report(float(val_accs[i]), epoch)
                    if epoch >= self.min_epochs and t.should_prune():
                        pruned[i] = True  # lockstep: slot keeps computing
            pruned = self._share(pruned)

        values = []
        for i, t in enumerate(trials):
            final = float(history[-1]["val_acc"][i]) if history else None
            values.append(float("nan") if pruned[i] else final)
            if self.rank != 0:
                continue
            if pruned[i]:
                self.study.tell(t, t.intermediate_values.get(t.last_step),
                                TrialState.PRUNED)
            else:
                self.study.tell(t, final, TrialState.COMPLETE)
        return VmappedResult(
            trial_numbers=numbers,
            values=values, states=states, history=history,
        )

    # -- slot recycling ------------------------------------------------------------
    def run_continuous(self, k: int = 8, total_trials: int = 16) -> list[Trial]:
        """Process ``total_trials`` trials through K always-busy slots.

        A slot's trial trains until it is pruned (Hyperband) or reaches the
        ``epochs`` budget; the slot is then re-initialised with a fresh
        suggestion. K stays constant so nothing is rebuilt. Returns the
        finished trials in order (on ranks other than 0, copies without
        their study).
        """
        self._check_k(k)
        fns = self._build_exec()
        trials, hp, _ = self._ask_shared(k)
        asked = k
        states = self._init_states(fns, hp)
        mine = range(self.slot0, self.slot0 + states.k)
        ls_arr, ma_arr = (hp[n][mine.start:mine.stop].copy() for n in ("ls", "ma"))
        slot_epoch = [0] * k
        active = [True] * k
        finished: list[Trial] = []
        global_epoch = 0

        while any(active):
            val_accs, _ = self._epoch(fns, states, ls_arr, ma_arr, global_epoch)
            global_epoch += 1

            recycled = []   # (slot, its new trial's hyperparameter row, asked)
            for i in range(k) if self.rank == 0 else ():
                if not active[i]:
                    continue
                t = trials[i]
                t.report(float(val_accs[i]), slot_epoch[i])
                done = slot_epoch[i] + 1 >= self.epochs
                pruned = slot_epoch[i] >= self.min_epochs and t.should_prune()
                if not (done or pruned):
                    slot_epoch[i] += 1
                    continue
                self.study.tell(
                    t,
                    float(val_accs[i]),
                    TrialState.PRUNED if pruned and not done else TrialState.COMPLETE,
                )
                finished.append(t)
                if asked < total_trials:
                    # recycle the slot with a fresh suggestion
                    new_trials, nhp = self._ask_batch(1)
                    trials[i] = new_trials[0]
                    asked += 1
                    recycled.append((i, {n: v[0] for n, v in nhp.items()}, asked))
                    slot_epoch[i] = 0
                else:
                    active[i] = False
            recycled, active = self._share((recycled, active))
            for i, row, n in recycled:
                if i not in mine:
                    continue
                new_state = fns["init_one"](_slot_seed(self.seed, 1000 + n), row["lr"],
                                            row["wd"], row["do"], row["tm"], row["wu"])
                states.scatter(new_state, i - mine.start)
                ls_arr[i - mine.start] = row["ls"]
                ma_arr[i - mine.start] = row["ma"]
        if self.group is None:
            return finished
        copies = self._share([dataclasses.replace(t, study=None) for t in finished]
                             if self.rank == 0 else None)
        return finished if self.rank == 0 else copies


__all__ = ["VMAPPABLE", "schedule_factor", "TrialStates", "TrialMetrics", "VmappedResult",
           "VmappedTrialRunner"]
