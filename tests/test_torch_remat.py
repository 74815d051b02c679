"""The remat policies (``dlsc_tpu_torch/models/vit.py`` ``REMAT_POLICIES``)
against no-remat and against the JAX package's policies on the CPU.

For each of the JAX package's seven policies on a tiny AST trunk (2 blocks,
64 wide; a tiny AST-MoE for ``attn_res_moe``), at dropout 0.1 with one seed:

- the gradients equal ``full``'s within 1e-6 normalised by each
  parameter's max |grad| in f32 (the same ops rerun in the same order, so
  they come out equal; measured 0);
- a ``TorchDispatchMode`` over the backward counts what the policy reruns:
  the attention op (``dlsc_tpu_torch::mha``) once a block under ``full``,
  ``dots`` and ``attn_out``, never under the ``attn_res*`` policies; no
  linear layer's GEMM under ``dots``; no qkv GEMM under ``attn_res_qkv``,
  no fc1 GEMM under ``attn_res_fc1``; no grouped-product forward
  (``dlsc_tpu_torch::gmm``) and no sort under ``attn_res_moe``;
- one SGD step under the policy (dropout 0, which the two packages draw
  differently) against the JAX model's step under the same policy on the
  same weights and features: loss 1e-5 relative, every parameter after the
  step within 1e-4 of JAX's normalised by its largest change (f32
  summation order; the port pads the tokens to 128 and masks them).

The tags the policies read are set only inside a checkpointed block, in its
forward and its recompute; elsewhere ``remat_tag`` is a shared no-op.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from dlsc_tpu.models.moe import MoeSpec as JaxMoeSpec
from dlsc_tpu.models.vit import ASTViT as JaxASTViT
from dlsc_tpu_torch.models.convert import params_from_jax
from dlsc_tpu_torch.models.vit import REMAT_POLICIES, ASTViT

DENSE = dict(num_classes=7, emb_dim=64, depth=2, num_heads=2, patch_size=16, patch_stride=10,
             overlap=6)
MOE = dict(DENSE, patch_stride=16, overlap=0)
MOE_SPEC = dict(n_experts=4, top_k=2, dispatch="ragged")
LR = 0.5
aten = torch.ops.aten


class OpCount(TorchDispatchMode):
    """The ops that run while it is on, with their output shapes."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops.append((func, tuple(out.shape) if isinstance(out, torch.Tensor) else None))
        return out

    def count(self, func, width=None) -> int:
        """Runs of ``func``, of those with an output ``width`` wide if given."""
        return sum(f == func and (width is None or s[-1] == width) for f, s in self.ops)


def _x(batch=2, frames=276):
    return torch.from_numpy(np.random.default_rng(3).standard_normal((batch, 128, frames))
                            .astype(np.float32))


def _model(policy: str, moe: bool = False, dropout: float = 0.1) -> ASTViT:
    kw = MOE if moe else DENSE
    return ASTViT(**kw, dtype=torch.float32, remat=True, remat_policy=policy, dropout=dropout,
                  moe=MOE_SPEC if moe else None,
                  generator=torch.Generator().manual_seed(0)).train()


def _backward(model: ASTViT) -> tuple[list[torch.Tensor], OpCount]:
    out, aux, _ = model(_x(), dropout_seed=11, return_aux=True)
    loss = out.square().sum() + aux
    with OpCount() as ops:
        loss.backward()
    return [p.grad for p in model.parameters()], ops


def test_the_seven_jax_policies():
    assert tuple(REMAT_POLICIES) == ("full", "dots", "attn_out", "attn_res", "attn_res_qkv",
                                     "attn_res_fc1", "attn_res_moe")
    with pytest.raises(ValueError, match="remat_policy"):
        _model("attn_res_everything")


@pytest.mark.parametrize("policy", REMAT_POLICIES)
def test_gradients_equal_full_and_what_reruns(policy):
    moe = policy == "attn_res_moe"
    want, _ = _backward(_model("full", moe))
    got, ops = _backward(_model(policy, moe))
    for a, b in zip(got, want):
        assert ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item() < 1e-6
    depth, D = DENSE["depth"], DENSE["emb_dim"]
    mha = ops.count(torch.ops.dlsc_tpu_torch.mha.default)
    assert mha == (0 if policy.startswith("attn_res") else depth)
    gemm = {name: ops.count(aten.addmm.default, n) for name, n in (("qkv", 3 * D),
                                                                    ("fc1", 4 * D))}
    if policy == "dots":
        assert ops.count(aten.addmm.default) == 0
    elif policy == "attn_res_qkv":
        assert gemm == dict(qkv=0, fc1=depth)
    elif policy == "attn_res_fc1":
        assert gemm == dict(qkv=depth, fc1=0)
    elif not moe:
        assert gemm == dict(qkv=depth, fc1=depth)
    gmm, sort = ops.count(torch.ops.dlsc_tpu_torch.gmm.default), ops.count(aten.sort.stable)
    if moe:
        assert (gmm, sort) == (0, 0)
        _, attn_res = _backward(_model("attn_res", moe=True))
        assert attn_res.count(torch.ops.dlsc_tpu_torch.gmm.default) == 2 * depth
        assert attn_res.count(aten.sort.stable) == depth


def test_tags_only_inside_a_checkpointed_block(monkeypatch):
    """Outside a checkpoint (serving, no remat) ``remat_tag`` is one shared
    no-op context and sets no tag; the forward and the recompute of a
    checkpointed block both see the tags."""
    from dlsc_tpu_torch.utils import remat

    assert remat.remat_tag("qkv") is remat.remat_tag("fc1")
    with remat.remat_tag("qkv"):
        assert remat.current_tag() is None
    seen = []
    real = remat.remat_tag

    def spy(name):
        seen.append((name, remat.current_tag() is None and real(name) is not remat._NO_TAG))
        return real(name)

    monkeypatch.setattr("dlsc_tpu_torch.models.vit.remat_tag", spy)
    with torch.no_grad():
        _model("attn_res_qkv").eval()(_x())
    assert seen and not any(on for _, on in seen)
    seen.clear()
    model = _model("attn_res_qkv", dropout=0.0)
    model(_x()).square().sum().backward()
    qkv = [on for name, on in seen if name == "qkv"]
    assert qkv == [True] * (2 * DENSE["depth"])   # the forward and the recompute


@pytest.mark.parametrize("policy", REMAT_POLICIES)
def test_step_matches_jax_under_the_same_policy(policy):
    moe = policy == "attn_res_moe"
    kw = MOE if moe else DENSE
    x = _x(frames=101)
    jmodel = JaxASTViT(**kw, dropout=0.0, dtype=jnp.float32, remat=True, remat_policy=policy,
                       scan_blocks=False,
                       moe=JaxMoeSpec(**MOE_SPEC) if moe else None)
    params = jmodel.init({"params": jax.random.key(0)}, jnp.asarray(x.numpy()),
                         train=False)["params"]

    def jloss(p):
        out, state = jmodel.apply({"params": p}, jnp.asarray(x.numpy()), train=True,
                                  mutable=["intermediates"])
        sown = jax.tree_util.tree_flatten_with_path(state.get("intermediates", {}))[0]
        aux = sum(v for path, v in sown if "moe_aux" in jax.tree_util.keystr(path))
        return jnp.sum(out ** 2) + aux

    jl, jg = jax.jit(jax.value_and_grad(jloss))(params)
    jnew = jax.tree_util.tree_map(lambda p, g: np.asarray(p - LR * g), params, jg)
    model = _model(policy, moe, dropout=0.0)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params), model))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    out, aux, _ = model(x, return_aux=True)
    loss = out.square().sum() + aux
    loss.backward()
    with torch.no_grad():
        for p in model.parameters():
            p -= LR * p.grad
    assert loss.item() == pytest.approx(float(jl), rel=1e-5)
    want = params_from_jax(jnew, model)
    for name, p in model.state_dict().items():
        scale = (want[name] - before[name]).abs().max().clamp_min(1e-30)
        assert ((p - want[name]).abs().max() / scale).item() < 1e-4, name
