"""The timm/DeiT weight import (``dlsc_tpu_torch/models/ast.py``
``interpolate_pos_embed``, ``load_torch_vit`` and
``dlsc_tpu_torch/scripts/import_vit.py``) against the JAX package's
``dlsc_tpu/models/ast.py`` on the CPU.

State dicts with timm's ``deit_base_patch16_384`` key layout (24 × 24 patch
grid, packed qkv, distilled and ``model.``-prefixed variants) at tiny widths
(96 wide, 2 blocks), built in memory from a numpy seed. Tolerances, each
with its reason:

- ``interpolate_pos_embed`` within 1e-6 of the JAX function, normalised by
  its max |value| (unit-normal tables), at the JAX test's upsampling grid
  (6 × 6 → AST's 12 × 275) and at a DeiT-384 grid (24 × 24 → 12 × 275, the
  frequency axis shrinking): the same half-pixel, antialiased bilinear
  weights, computed and applied in another order (measured 1.2e-6 absolute
  at values up to ~4, a few ulps);
- ``load_torch_vit``: every copied and channel-meaned tensor exactly equal
  to ``params_from_jax`` of the JAX import (the same numpy operations), the
  positional table within 1e-6 (as above);
- the ``import_vit`` CLI's weights equal ``load_torch_vit``'s exactly.

``test_jax_gap_to_the_reference_interpolation`` prints how far the JAX
function (and so the port) is from the reference's
``F.interpolate(align_corners=False)`` without antialiasing where the grid
shrinks (ROADMAP §3); it asserts nothing about that gap's size.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dlsc_tpu.models import ast as JA
from dlsc_tpu_torch.models import ast as A
from dlsc_tpu_torch.models.convert import params_from_jax
from dlsc_tpu_torch.scripts import export
from dlsc_tpu_torch.scripts import import_vit
from dlsc_tpu_torch.serving import load_exported
from dlsc_tpu_torch.train.checkpoint import load_params

D, DEPTH, HEADS, GRID, C = 96, 2, 4, 24, 7
AST_GRID = (12, 275)   # AST's patch grid at 44.1 kHz, 10 s, patch 16, stride 10


def _deit_sd(prefix: str = "", distilled: bool = False, extra: dict | None = None) -> dict:
    """timm ``deit_base_patch16_384``'s keys and layouts at width ``D``."""
    rng = np.random.default_rng(7)

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32) * 0.02

    n_prefix = 2 if distilled else 1
    sd = {"cls_token": r(1, 1, D), "pos_embed": r(1, n_prefix + GRID * GRID, D),
          "patch_embed.proj.weight": r(D, 3, 16, 16), "patch_embed.proj.bias": r(D),
          "norm.weight": r(D), "norm.bias": r(D), "head.weight": r(1000, D),
          "head.bias": r(1000)}
    if distilled:
        sd.update({"dist_token": r(1, 1, D), "head_dist.weight": r(1000, D),
                   "head_dist.bias": r(1000)})
    for i in range(DEPTH):
        b = f"blocks.{i}."
        sd.update({b + "norm1.weight": r(D), b + "norm1.bias": r(D),
                   b + "attn.qkv.weight": r(3 * D, D), b + "attn.qkv.bias": r(3 * D),
                   b + "attn.proj.weight": r(D, D), b + "attn.proj.bias": r(D),
                   b + "norm2.weight": r(D), b + "norm2.bias": r(D),
                   b + "mlp.fc1.weight": r(4 * D, D), b + "mlp.fc1.bias": r(4 * D),
                   b + "mlp.fc2.weight": r(D, 4 * D), b + "mlp.fc2.bias": r(D)})
    sd.update(extra or {})
    return {prefix + k: v for k, v in sd.items()}


@pytest.fixture(scope="module")
def jax_model():
    model = JA.ASTModel(num_classes=C, emb_dim=D, depth=DEPTH, num_heads=HEADS,
                        dtype=jnp.float32)
    params = jax.jit(model.init, static_argnames=("train",))(
        jax.random.key(0), jnp.zeros((1, 128, 128)), train=False)["params"]
    return model, params


def _port(params) -> A.ASTViT:
    """The port's model holding the JAX model's initial weights."""
    model = A.ASTModel(num_classes=C, emb_dim=D, depth=DEPTH, num_heads=HEADS,
                       dtype=torch.float32)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params), model))
    return model


@pytest.mark.parametrize("old,new", [((6, 6), AST_GRID), ((GRID, GRID), AST_GRID),
                                     ((6, 6), (9, 13))])
def test_pos_embed_interpolation_matches_jax(old, new):
    pe = np.random.default_rng(1).standard_normal((1, 1 + old[0] * old[1], 8)).astype(
        np.float32)
    got = A.interpolate_pos_embed(pe, old, new)
    want = np.asarray(JA.interpolate_pos_embed(pe, old, new))
    assert got.shape == want.shape == (1, 1 + new[0] * new[1], 8) and got.dtype == np.float32
    np.testing.assert_array_equal(got[:, 0], pe[:, 0])
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-6


def test_jax_gap_to_the_reference_interpolation():
    """The reference resizes with ``F.interpolate(align_corners=False)``, no
    antialiasing; the JAX function antialiases the shrinking axis (24 → 12)
    and so does the port, which follows it. Prints the gap."""
    grid = np.random.default_rng(0).standard_normal((1, GRID, GRID, 8)).astype(np.float32)
    pe = np.concatenate([np.zeros((1, 1, 8), np.float32), grid.reshape(1, -1, 8)], axis=1)
    jax_out = np.asarray(JA.interpolate_pos_embed(pe, (GRID, GRID), AST_GRID))[:, 1:]
    ref = F.interpolate(torch.from_numpy(grid).permute(0, 3, 1, 2), size=AST_GRID,
                        mode="bilinear", align_corners=False)
    ref = ref.permute(0, 2, 3, 1).reshape(1, -1, 8).numpy()
    gap = np.abs(jax_out - ref)
    print(f"JAX interpolate_pos_embed vs F.interpolate(antialias=False), (1, {GRID}, {GRID}, 8)"
          f" f32 -> {AST_GRID}: max {gap.max():.3g}, rms {np.sqrt((gap ** 2).mean()):.3g}")
    port_out = A.interpolate_pos_embed(pe, (GRID, GRID), AST_GRID)[:, 1:]
    assert np.abs(port_out - jax_out).max() < 1e-6


@pytest.mark.parametrize("layout", ["plain", "model.", "distilled"])
def test_load_matches_the_jax_import(jax_model, layout):
    jmodel, params = jax_model
    sd = _deit_sd(prefix="model." if layout == "model." else "",
                  distilled=layout == "distilled")
    jaudit, audit = {}, {}
    want = params_from_jax(JA.load_torch_vit(params, sd, jmodel, audit=jaudit), _port(params))
    model = _port(params)
    got = A.load_torch_vit(sd, model, audit=audit)
    assert set(got) == set(want)
    for k in want:
        if k == "pos_embed":
            assert (got[k] - want[k]).abs().max().item() < 1e-6
        else:
            assert torch.equal(got[k], want[k]), k
    assert set(audit) == set(jaudit)
    for k in ("n_source_keys", "consumed", "ignored", "leftover", "n_target_leaves"):
        assert audit[k] == jaudit[k], k
    assert len(audit["notes"]) == 2 and "channel-mean" in audit["notes"][0]
    assert "bilinear 2-D interpolation" in audit["notes"][1]
    model.load_state_dict(got)   # every key and shape the model's


def test_unknown_and_missing_keys_raise(jax_model):
    jmodel, params = jax_model
    model = _port(params)
    sd = _deit_sd(extra={"some.novel.weight": np.zeros(3, np.float32)})
    for fn in (lambda: A.load_torch_vit(sd, model), lambda: JA.load_torch_vit(params, sd,
                                                                               jmodel)):
        with pytest.raises(ValueError, match="unconsumed"):
            fn()
    A.load_torch_vit(sd, model, strict=False)   # non-strict: loads anyway
    sd = _deit_sd()
    del sd["blocks.1.attn.qkv.weight"]
    for fn in (lambda: A.load_torch_vit(sd, model), lambda: JA.load_torch_vit(params, sd,
                                                                               jmodel)):
        with pytest.raises(KeyError, match="blocks.1.attn.qkv.weight"):
            fn()


def test_import_vit_cli(tmp_path, capsys):
    """A wrapped ``{"model": sd}`` .pth → ``--audit`` (writes nothing) → the
    weights directory, which ``load_params`` reads and ``export
    +ckpt_path= +quant=w8`` serves from."""
    sd = {k: torch.from_numpy(v) for k, v in _deit_sd().items()}
    pth = tmp_path / "toy_deit.pth"
    torch.save({"model": sd, "epoch": 300}, pth)
    args = ["--checkpoint", str(pth), "--num-classes", str(C), "--emb-dim", str(D),
            "--depth", str(DEPTH), "--num-heads", str(HEADS)]
    assert import_vit.main([*args, "--out", str(tmp_path / "audit"), "--audit",
                            "--device", "cpu"]) is None
    text = capsys.readouterr().out
    for line in ("AUDIT OK", "channel-mean", "bilinear 2-D interpolation", "finite=True"):
        assert line in text
    assert not (tmp_path / "audit").exists()

    out = import_vit.main([*args, "--out", str(tmp_path / "pretrained")])
    model = A.ASTModel(num_classes=C, emb_dim=D, depth=DEPTH, num_heads=HEADS,
                       dtype=torch.float32, generator=torch.Generator().manual_seed(0))
    want = A.load_torch_vit(sd, model)
    got = load_params(out, model)
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)

    art = export.main(["model=ast", f"+ckpt_path={out}", f"+out={tmp_path / 'art'}",
                       "+quant=w8", f"dataset.num_classes={C}", f"+model.emb_dim={D}",
                       f"+model.depth={DEPTH}", f"+model.num_heads={HEADS}",
                       "+dtype=float32", "+batch=2", "+clip_samples=16000"])
    serve = load_exported(art, device="cpu")
    assert torch.equal(serve.model.cls_token, want["cls_token"])
    probs = serve(np.random.default_rng(2).standard_normal((2, 16_000)).astype(np.float32))
    assert probs.shape == (2, C) and np.allclose(probs.sum(-1), 1.0, atol=1e-5)
