"""Port parity of expert parallelism (and FSDP + EP), MoE under data
parallelism, pipeline parallelism (and pipeline x tensor parallelism),
against the JAX package on its virtual mesh.

As ``tests/test_torch_parallel.py``: the port on 2 gloo ranks, and on 4
for FSDP + EP (2 'data' x 2 'model') and PP x TP (2 stages x 2 'model'),
one spawn of each size for the file (``tests/dist_workers.py``), the JAX
side once in the pytest process, the JAX draws rebuilt from its key, small AST-MoE / ViT models
(width 32, depth 2, 2 heads, 4 experts, top-2, patch 16 / stride 16).
The MoE runs are compared on their own routes, not replayed ones: at this
size and in f32 no near-tie flips a route between the two packages (a flip
would move a whole expert's gradient, far past any bar below). Tolerances:

- loss 1e-5 relative, every parameter after each SGD step within 1e-4 of
  its largest change (the JAX mesh tests' bars; the port pads the tokens to
  the 128 grain and masks them, JAX runs them unpadded);
- PP: the JAX pipeline tests' 2e-5 relative on the loss, parameters as
  above;
- the MoE stats (drop fraction, expert utilisation) 1e-5 relative: the
  global batch's on both sides;
- the port on 2 ranks against 1, dropout on: 1e-5 of each parameter's
  largest value (measured 3.3e-7 under DDP, 1.6e-7 under EP).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlsc_tpu.models.moe import MOE_METRICS as JAX_MOE_METRICS
from dlsc_tpu.models.moe import MoeSpec as JaxMoeSpec
from dlsc_tpu.models.vit import ASTViT as JaxASTViT
from dlsc_tpu.parallel import MeshPlan as JaxMeshPlan
from dlsc_tpu.parallel import get_mesh as jax_get_mesh
from dlsc_tpu.parallel import make_plan as jax_make_plan
from dlsc_tpu.parallel.ep import expert_sharding as jax_expert_sharding
from dlsc_tpu.parallel.ep import fsdp_ep_state_shardings, moe_param_shardings
from dlsc_tpu.parallel.pp import get_pp_mesh as jax_get_pp_mesh
from dlsc_tpu.parallel.pp import make_pp_apply_fn, pp_state_shardings
from dlsc_tpu.parallel.pp_tp import get_pp_tp_mesh as jax_get_pp_tp_mesh
from dlsc_tpu.parallel.pp_tp import vit_apply_pp_tp
from dlsc_tpu_torch.models.convert import params_from_jax
from dlsc_tpu_torch.models.moe import MOE_METRICS
from dlsc_tpu_torch.parallel import spawn
from tests import dist_workers as dw
from tests.test_torch_parallel import AST_PIPE, B, FRAMES, SGD, _batch, _jax_steps, _param_errs

W = 2
GEOM = dict(num_classes=5, emb_dim=32, depth=2, num_heads=2, patch_size=16, patch_stride=16,
            overlap=0)


def _moe(dispatch):
    return dict(n_experts=4, top_k=2, dispatch=dispatch)


def _jax_model(moe=None, **kw):
    return JaxASTViT(**GEOM, dropout=0.0, dtype=jnp.float32, remat=False,
                     moe=None if moe is None else JaxMoeSpec(**moe), **kw)


def _port_kw(moe=None, dropout=0.0):
    return dict(GEOM, dtype="float32", remat=False, moe=moe, dropout=dropout)


def _init(jmodel):
    feats = jnp.zeros((B, 128, FRAMES), jnp.float32)
    return jax.jit(jmodel.init, static_argnames="train")({"params": jax.random.key(0)}, feats,
                                                        train=False)["params"]


def _sd(params, kw):
    model = dw.build_model("vit", kw)
    return {k: v.numpy() for k, v in params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                                     model).items()}


def _spec(layout, kw, init, wave, labels, draws, **extra):
    return dict(model="vit", model_kw=kw, init=init, pipe=AST_PIPE, layout=layout, wave=wave,
                labels=labels, steps=len(draws), draws=draws, opt=SGD, cosine_t_max=4, clip=1.0,
                **extra)


def _pp_tp_apply(jm, mesh, n_micro):
    """``state.apply_fn`` through ``vit_apply_pp_tp`` (as ``make_pp_apply_fn``
    wraps ``vit_apply_pp``, the MoE aux loss under ``moe_aux``)."""
    def apply_fn(variables, inputs, train=False, rngs=None, mutable=None):
        out = vit_apply_pp_tp(jm, variables, inputs, mesh=mesh, n_micro=n_micro, train=train,
                              rng=(rngs or {}).get("dropout"))
        if mutable is None:
            return out
        if isinstance(out, tuple):   # MoE training: (logits, aux)
            return out[0], {"intermediates": {"moe_aux": (out[1],)}}
        return out, {}
    return apply_fn


def _dropout_specs():
    """EP, ragged MoE under DP, and PP with dropout 0.1, SpecAugment and
    Mixup, remat 'attn_res' (and the W = 1 reference run of each)."""
    wave, labels = _batch(3, 4, 8000)
    out = []
    for layout, kw in (("ep", _port_kw(_moe("einsum"), 0.1)),
                       ("ddp", _port_kw(_moe("ragged"), 0.1)),
                       ("pp", _port_kw(None, 0.1))):
        kw = dict(kw, remat=True, remat_policy="attn_res")
        init = {k: v.numpy() for k, v in dw.build_model("vit", kw).state_dict().items()}
        out.append(dict(model="vit", model_kw=kw, init=init, pipe=AST_PIPE, layout=layout,
                        wave=wave, labels=labels, steps=2, draw_seed=3, dropout_seeds=[11, 12],
                        opt=("sgd", dict(lr=0.5)), n_micro=2))
    return out


def _four_rank_dropout_specs():
    """FSDP + EP and PP x TP with dropout (and attention dropout under TP)."""
    ep, _, pp = _dropout_specs()
    kw = dict(pp["model_kw"], attn_dropout=0.1)
    return [dict(ep, layout="fsdp_ep"),
            dict(pp, layout="pp_tp", model_kw=kw,
                 init={k: v.numpy() for k, v in dw.build_model("vit", kw).state_dict().items()})]


@pytest.fixture(scope="module")
def runs():
    wave, labels = _batch(0)
    ref, specs = {}, []
    # expert parallelism: experts over 'model' (JAX data=4 x model=2)
    ep_plan = JaxMeshPlan(jax_get_mesh(8, model_parallel=2))
    jm = _jax_model(_moe("einsum"), expert_sharding=jax_expert_sharding(ep_plan.mesh))
    params = _init(jm)
    ref["ep"] = _jax_steps(jm, params, wave, labels, 2, ep_plan,
                           moe_param_shardings(params, ep_plan.mesh))
    kw = _port_kw(_moe("einsum"))
    specs.append(_spec("ep", kw, _sd(params, kw), wave, labels, ref["ep"][2]))
    # the dropless ragged MoE under data parallelism (the 8-device batch axis)
    jm = _jax_model(_moe("ragged"))
    params = _init(jm)
    ref["moe_dp"] = _jax_steps(jm, params, wave, labels, 2, jax_make_plan(8),
                               extras=JAX_MOE_METRICS)
    kw = _port_kw(_moe("ragged"))
    specs.append(_spec("ddp", kw, _sd(params, kw), wave, labels, ref["moe_dp"][2],
                       extras=MOE_METRICS))
    # GPipe: dense on data=4 x stage=2; MoE (its aux estimator per microbatch
    # and data shard) on data=1 x stage=2, as the port's 2 ranks
    for name, moe, n_dev in (("pp", None, 8), ("pp_moe", _moe("ragged"), 2)):
        plan = JaxMeshPlan(jax_get_pp_mesh(n_dev, 2))
        jm = _jax_model(moe)
        params = _init(jm)
        ref[name] = _jax_steps(jm, params, wave, labels, 2, plan,
                               apply_fn=make_pp_apply_fn(jm, plan.mesh, 2),
                               state_sh=lambda st, m=plan.mesh: pp_state_shardings(st, m))
        kw = _port_kw(moe)
        specs.append(_spec("pp", kw, _sd(params, kw), wave, labels, ref[name][2], n_micro=2))
    # FSDP + EP on 4 ranks against JAX's fsdp_ep_state_shardings (data=4 x model=2)
    jm = _jax_model(_moe("einsum"), expert_sharding=jax_expert_sharding(ep_plan.mesh))
    params = _init(jm)
    ref["fsdp_ep"] = _jax_steps(jm, params, wave, labels, 2, ep_plan,
                                state_sh=lambda st: fsdp_ep_state_shardings(st, ep_plan.mesh))
    kw = _port_kw(_moe("einsum"))
    four = [_spec("fsdp_ep", kw, _sd(params, kw), wave, labels, ref["fsdp_ep"][2])]
    # PP x TP on 4 ranks against vit_apply_pp_tp on data=2 x stage=2 x model=2
    plan = JaxMeshPlan(jax_get_pp_tp_mesh(8, 2, 2))
    jm = _jax_model()
    params = _init(jm)
    ref["pp_tp"] = _jax_steps(jm, params, wave, labels, 2, plan,
                              apply_fn=_pp_tp_apply(jm, plan.mesh, 2),
                              state_sh=lambda st: pp_state_shardings(st, plan.mesh))
    kw = _port_kw()
    four.append(_spec("pp_tp", kw, _sd(params, kw), wave, labels, ref["pp_tp"][2], n_micro=2))
    # PP x TP ragged AST-MoE (each expert's hidden dim over 'model') against
    # vit_apply_pp_tp on data=1 x stage=2 x model=2, as the port's 4 ranks
    plan = JaxMeshPlan(jax_get_pp_tp_mesh(4, 2, 2))
    jm = _jax_model(_moe("ragged"))
    params = _init(jm)
    ref["pp_tp_moe"] = _jax_steps(jm, params, wave, labels, 2, plan,
                                  apply_fn=_pp_tp_apply(jm, plan.mesh, 2),
                                  state_sh=lambda st: pp_state_shardings(st, plan.mesh))
    kw = _port_kw(_moe("ragged"))
    four.append(_spec("pp_tp", kw, _sd(params, kw), wave, labels, ref["pp_tp_moe"][2],
                      n_micro=2))
    drop, drop4 = _dropout_specs(), _four_rank_dropout_specs()
    two = spawn(dw.run_all, W, specs + drop, timeout_s=600)[0]
    fours = spawn(dw.run_all, 4, four + drop4, timeout_s=600)[0]
    one = dw.run_all(drop + drop4)
    # runs["two"][i] is the run of runs["specs"][i]
    return dict(ref=ref, specs=specs + drop + four + drop4, two=two + fours, one=one)


@pytest.mark.parametrize("i,name", [(0, "ep"), (1, "moe_dp"), (2, "pp"), (3, "pp_moe"),
                                    (7, "fsdp_ep"), (8, "pp_tp")])
def test_matches_jax_mesh(runs, i, name):
    """Two steps (SGD + momentum, cosine, clip 1.0, SpecAugment and Mixup on
    the global batch of 8) of: the einsum AST-MoE with its experts split over
    2 ranks (all-to-all dispatch) against JAX's ``expert_sharding``; the
    ragged AST-MoE on 2 DDP ranks (aux loss and stats over the global
    batch) against the JAX step on the 8-device batch axis; GPipe over 2
    stages and 2 microbatches, dense and MoE, against ``vit_apply_pp``;
    on 4 ranks, FSDP + EP against the JAX step under
    ``fsdp_ep_state_shardings``, and GPipe with each stage's blocks split
    over 2 'model' ranks against ``vit_apply_pp_tp``."""
    params, losses, _, jms = runs["ref"][name]
    got = runs["two"][i]
    kw = runs["specs"][i]["model_kw"]
    rtol = 2e-5 if name.startswith("pp") else 1e-5
    np.testing.assert_allclose(got["loss"], losses, rtol=rtol)
    before = runs["specs"][i]["init"]
    for step in range(2):
        want = _sd(params[step], kw)
        errs = _param_errs(got["params"][step], want, before)
        assert max(errs.values()) < 1e-4, sorted(errs.items(), key=lambda kv: -kv[1])[:3]
        before = want
    np.testing.assert_array_equal(got["confmat"], np.asarray(jms.confmat))
    if name == "moe_dp":
        sums = {k: float(v) / int(jms.batches) for k, v in jms.extra_sums.items()}
        for k in MOE_METRICS:
            assert got["extras"][k] == pytest.approx(sums[k], rel=1e-5, abs=1e-7), k


@pytest.mark.parametrize("j,name", [(0, "ep"), (1, "moe_ddp"), (2, "pp"), (3, "fsdp_ep"),
                                    (4, "pp_tp")])
def test_modes_match_one_rank_with_dropout(runs, j, name):
    """Two steps with dropout 0.1 (the experts' too), SpecAugment, Mixup
    and remat on 2 ranks against 1 (the counter-based draw: a split draws
    its elements' bits of the unsplit tensor): expert parallelism (a rank's
    experts), the ragged MoE under DDP (its masks drawn per (token, choice)
    in the sort order, so the sort does not matter), GPipe (a microbatch's
    rows); on 4 ranks FSDP + EP and PP x TP (a rank's heads and hidden
    units too)."""
    got, want = runs["two"][(4, 5, 6, 10, 11)[j]], runs["one"][j]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
    for g, w in zip(got["params"], want["params"]):
        for k in w:
            assert np.abs(g[k] - w[k]).max() <= 1e-5 * max(np.abs(w[k]).max(), 1e-3), k


def test_pp_tp_moe_matches_jax(runs):
    """Two steps of the ragged AST-MoE under GPipe over 2 stages with each
    stage's experts' hidden units over 2 'model' ranks (K4a / K4b at F/2 on
    the card), against ``vit_apply_pp_tp`` with ``test_moe.py:467``'s bars:
    the loss 2e-6 relative, the outputs' confusion matrix equal, and the
    first step's gradient (its change over the learning rate: the clipped
    gradient, the same clip factor on both sides) within 2e-5 absolute
    (measured 1.6e-7); each step's parameters
    within 1e-4 of their largest change, as the other meshes'. A change of
    wi is a difference of f32 parameters hundreds of times larger than it,
    so one f32 spacing is a few 1e-5 of it: the absolute bar is the
    gradient's."""
    params, losses, _, jms = runs["ref"]["pp_tp_moe"]
    got, spec = runs["two"][9], runs["specs"][9]
    np.testing.assert_allclose(got["loss"], losses, rtol=2e-6)
    np.testing.assert_array_equal(got["confmat"], np.asarray(jms.confmat))   # the outputs
    before = spec["init"]
    lr = spec["opt"][1]["lr"]
    for step in range(2):
        want = _sd(params[step], spec["model_kw"])
        errs = _param_errs(got["params"][step], want, before)
        assert max(errs.values()) < 1e-4, sorted(errs.items(), key=lambda kv: -kv[1])[:3]
        if step == 0:
            for k, w in want.items():
                np.testing.assert_allclose((before[k] - got["params"][0][k]) / lr,
                                           (before[k] - w) / lr, rtol=0, atol=2e-5, err_msg=k)
        before = want
