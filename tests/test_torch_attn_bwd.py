"""Port parity: kernel K2b's module (masked attention backward) and the
differentiable op around K2f and K2b.

``mha_backward_reference``, what a CPU tensor runs and the kernel's oracle
on the card, is held against the JAX fast backward (``make_fast_mha(...,
bwd_impl="fast")`` in interpret mode, through ``jax.vjp``) on the same
numpy-seeded f32 inputs, at tests/test_attn_fast.py's 5e-5 normalised by
the max |gradient|; and against torch autograd of ``mha_forward_reference``
at 1e-5 normalised (f32 both sides, only the summation order differs). dK
and dV rows >= n_real are exact zeros. The op ``fast_mha_lse`` passes
``torch.library.opcheck`` and its CPU gradients equal the plain ones.

The bf16 kernel's launch plan (``_bwd_plan``: grids, tiles streamed, CTAs
that only write zeros, shared memory within the H100's 227 KB) is checked
at the main path's shapes and at ragged ones, and the build cache's key
(``_kernels._paths``) at a change of a shared header; neither needs nvcc.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlsc_tpu.ops.attn_fast import make_fast_mha
from dlsc_tpu_torch import _kernels
from dlsc_tpu_torch.ops import attn_fast as A

H, N, DH = 2, 256, 64


def _inputs(seed=0, b=1, n=N, h=H):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((b, h, n, DH)).astype(np.float32) for _ in range(4))
    return q * np.float32(DH**-0.5), k, v, do


def _norm_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _reference_grads(q, k, v, do, n_real):
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    out, lse = A.mha_forward_reference(*t[:3], n_real)
    return A.mha_backward_reference(*t[:3], out, lse, t[3], n_real)


@pytest.mark.parametrize("n_real", [N, 200])
def test_reference_matches_pallas_backward(n_real):
    q, k, v, do = _inputs()
    kernel = make_fast_mha(H, N, DH, n_real, 128, 128, 128, "float32", interpret=True,
                           bwd_impl="fast")
    _, vjp = jax.vjp(kernel, *(jnp.asarray(x[0]) for x in (q, k, v)))
    want = vjp(jnp.asarray(do[0]))
    got = _reference_grads(q, k, v, do, n_real)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _norm_err(g[0].numpy(), w) < 5e-5, name


@pytest.mark.parametrize("n,n_real", [(256, 256), (256, 200), (200, 131), (130, 2)])
def test_reference_matches_autograd(n, n_real):
    q, k, v, do = _inputs(seed=n + n_real, b=2, n=n)
    got = _reference_grads(q, k, v, do, n_real)
    t = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out, _ = A.mha_forward_reference(*t, n_real)
    want = torch.autograd.grad(out, t, torch.from_numpy(do))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _norm_err(g.numpy(), w.numpy()) < 1e-5, name
    for g in got[1:]:  # pad keys: exact zeros, though dO is non-zero on every row
        assert (g[:, :, n_real:] == 0).all()


def test_reference_bf16_rounding():
    """bf16 inputs: the gradients come back in bf16, P and dS rounded before
    their products, within 2e-2 normalised of the f32 computation on the same
    (bf16-representable) values; zero tails stay exact."""
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16) for x in _inputs(seed=5))
    out, lse = A.mha_forward_reference(q, k, v, 200)
    got = A.mha_backward_reference(q, k, v, out, lse, do, 200)
    want = A.mha_backward_reference(q.float(), k.float(), v.float(), out.float(), lse,
                                    do.float(), 200)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert _norm_err(g.float().numpy(), w.numpy()) < 2e-2
    assert (got[1][:, :, 200:] == 0).all() and (got[2][:, :, 200:] == 0).all()


def test_cpu_tensor_takes_plain_backward():
    """A CPU tensor runs the plain version and launches nothing; a strided
    dO (as the model's head-merge transpose hands it back) is accepted."""
    A.reset_launches()
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(seed=2, b=2))
    out, lse = A.fast_mha_forward(q, k, v, 200)
    do_t = do.transpose(1, 2).contiguous().transpose(1, 2)   # same values, strided
    assert not do_t.is_contiguous()
    got = A.fast_mha_backward(q, k, v, out, lse, do_t, 200)
    want = A.mha_backward_reference(q, k, v, out, lse, do, 200)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert A.launches == 0 and A.bwd_launches == 0


def test_fast_mha_gradients_on_cpu():
    """The differentiable op: forward (out, lse) as the plain forward, and
    gradients equal to autograd of the plain forward (1e-5 normalised)."""
    q, k, v, do = _inputs(seed=3, b=2)
    t = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = A.fast_mha(*t, 200)
    got = torch.autograd.grad(out, t, torch.from_numpy(do))
    r = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    ref, _ = A.mha_forward_reference(*r, 200)
    want = torch.autograd.grad(ref, r, torch.from_numpy(do))
    assert torch.equal(out.detach(), ref.detach())
    for g, w in zip(got, want):
        assert _norm_err(g.numpy(), w.numpy()) < 1e-5
    _, lse = A.fast_mha_lse(*t, 200)
    assert not lse.requires_grad


def test_fast_mha_opcheck():
    """``fast_mha_lse`` is an ``autograd.Function`` over two custom ops: the
    forward ``dlsc_tpu_torch::mha`` and the backward
    ``dlsc_tpu_torch::mha_bwd``; each passes ``opcheck``."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(seed=4, b=1, n=128))
    torch.library.opcheck(torch.ops.dlsc_tpu_torch.mha.default, [q, k, v, 100])
    out, lse = A.mha_forward_reference(q, k, v, 100)
    torch.library.opcheck(torch.ops.dlsc_tpu_torch.mha_bwd.default,
                          [q, k, v, out, lse, do, 100])


def test_backward_rejects_bad_arguments():
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(seed=6))
    out, lse = A.mha_forward_reference(q, k, v, N)
    with pytest.raises(ValueError, match="n_real"):
        A.fast_mha_backward(q, k, v, out, lse, do, N + 1)
    with pytest.raises(ValueError, match="lse"):
        A.fast_mha_backward(q, k, v, out, lse[..., :128], do, N)
    with pytest.raises(ValueError, match="do"):
        A.fast_mha_backward(q, k, v, out, lse, do[:, :, :128], N)


# (B, H, N, n_real, key tiles the dQ kernel reads, all-masked dK/dV CTAs per
# batch x head): the five main-path shapes (AST-Base, AST-MoE / AST-Small,
# AST-Mini, the 10-s sequence, n_real == N), then ragged ones
@pytest.mark.parametrize("B,H,N,n_real,key_tiles,zero_ctas", [
    (64, 12, 1664, 1645, 26, 0),
    (64, 6, 768, 689, 11, 0),
    (64, 3, 1664, 1645, 26, 0),
    (8, 12, 3328, 3301, 52, 0),
    (8, 6, 768, 768, 12, 0),
    (2, 3, 200, 131, 3, 0),
    (2, 3, 130, 130, 3, 0),
    (2, 3, 256, 40, 1, 1),
])
def test_bwd_plan(B, H, N, n_real, key_tiles, zero_ctas):
    plan = A._bwd_plan(B, H, N, n_real)
    blocks = -(-N // 128)
    assert plan["dq_grid"] == plan["dkv_grid"] == (blocks, B * H)
    assert plan["threads"] == 288   # 2 consumer warpgroups and a producer warp
    assert plan["dq_key_tiles"] == key_tiles
    assert (plan["dq_key_tiles"] - 1) * 64 < n_real <= plan["dq_key_tiles"] * 64
    assert plan["dkv_query_tiles"] == -(-N // 64)
    assert plan["dkv_zero_ctas"] == zero_ctas * B * H
    # the zero-only CTAs are exactly those whose first key is >= n_real
    assert plan["dkv_zero_ctas"] == sum(kv0 >= n_real for kv0 in range(0, N, 128)) * B * H
    for key in ("dq_smem", "dkv_smem"):
        assert 48 * 1024 < plan[key] <= A.SMEM_LIMIT == 227 * 1024
    # a ring of at least two 64-row tiles of both streamed operands
    assert plan["dq_smem"] >= 1024 + 2 * 128 * 128 + 2 * 2 * 64 * 128
    assert plan["dkv_smem"] >= 1024 + 2 * 128 * 128 + 2 * 2 * 64 * 128


def test_build_key_covers_headers(tmp_path, monkeypatch):
    """A library's path hashes its source, every csrc/*.cuh and its flags:
    an edited header gives a new path (so it is rebuilt), an unrelated file
    does not."""
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_bytes(b"// one\n")
    monkeypatch.setattr(_kernels, "_CSRC", tmp_path)
    src, first = _kernels._paths("k")
    assert src == tmp_path / "k.cu" and first.name.startswith("libk-")
    assert _kernels._paths("k")[1] == first
    (tmp_path / "notes.txt").write_text("not a header")
    assert _kernels._paths("k")[1] == first
    (tmp_path / "h.cuh").write_bytes(b"// two\n")
    second = _kernels._paths("k")[1]
    assert second != first
    (tmp_path / "g.cuh").write_bytes(b"")
    assert _kernels._paths("k")[1] not in (first, second)
    monkeypatch.setitem(_kernels.EXTRA_FLAGS, "k", ("-lineinfo",))
    assert _kernels._paths("k")[1] not in (first, second)
