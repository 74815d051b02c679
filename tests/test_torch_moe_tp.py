"""AST-MoE under tensor parallelism (``parallel/tp.py``: each expert's
hidden dim split over the 'model' ranks, the router and bo replicated) on 2
gloo ranks against the port in one process, and the JAX refusals.

One spawn of 2 ranks for the file (``tests/dist_workers.py``): a tiny
AST-MoE (width 32, depth 2, 2 heads, 4 experts, top-2, F 128, patch 16 /
stride 16), f32, dropout 0.1 (the experts' hidden units and the block
outputs; a rank draws its slice of the unsplit hidden mask), SpecAugment
and Mixup on, one SGD step at lr 1 without momentum or clipping, so each
parameter's change is its gradient. Every dispatch and router that the JAX
block runs through ``MoeMlp``: token-choice on the ragged (K4a / K4b at
F/2), einsum and scatter dispatches, and expert-choice; and the ragged one
under sequence parallelism (JAX's ``token_sharding``). Bars:

- the loss 1e-5 relative;
- each parameter's gradient within 2e-5 of its largest entry (the ranks sum
  the partial expert outputs, the experts' input gradient and the combine
  weights' gradient in another order than one process: rounding only).

The PP x TP AST-MoE step against JAX's ``vit_apply_pp_tp`` is in
``tests/test_torch_ep_pp.py``.
"""

import numpy as np
import pytest

from dlsc_tpu_torch.parallel import spawn
from dlsc_tpu_torch.parallel.tp import EP_TP_ERROR
from tests import dist_workers as dw
from tests.test_torch_parallel import AST_PIPE, _batch

W = 2
GEOM = dict(num_classes=5, emb_dim=32, depth=2, num_heads=2, patch_size=16, patch_stride=16,
            overlap=0, dtype="float32", remat=False)
CASES = (("ragged", "token", "tp"), ("einsum", "token", "tp"), ("scatter", "token", "tp"),
         ("einsum", "expert", "tp"), ("ragged", "token", "sp"))


def _kw(dispatch, router, dropout=0.1):
    return dict(GEOM, dropout=dropout,
                moe=dict(n_experts=4, top_k=2, dispatch=dispatch, router=router))


def _specs():
    wave, labels = _batch(4, 4, 8000)
    out = []
    for dispatch, router, layout in CASES:
        kw = _kw(dispatch, router)
        init = {k: v.numpy() for k, v in dw.build_model("vit", kw).state_dict().items()}
        out.append(dict(model="vit", model_kw=kw, init=init, pipe=AST_PIPE, layout=layout,
                        wave=wave, labels=labels, steps=1, draw_seed=5, dropout_seeds=[17]))
    return out


@pytest.fixture(scope="module")
def runs():
    specs = _specs()
    errors = [dict(fn="tp_error", case=case, model_kw=_kw("ragged", "token", 0.0))
              for case in ("ep", "hidden")]
    two = spawn(dw.run_all, W, specs + errors, timeout_s=600)[0]
    return dict(specs=specs, two=two[:len(specs)], errors=two[len(specs):],
                one=dw.run_all(specs))


def _grads(run, init):
    return {k: init[k] - run["params"][0][k] for k in init}


@pytest.mark.parametrize("i,name", [(i, "-".join(c)) for i, c in enumerate(CASES)])
def test_tp_moe_matches_one_rank(runs, i, name):
    """One step of the tiny AST-MoE with its experts' hidden units over 2
    ranks equals the one-process step: loss, and the gradient of every
    parameter (router, experts, attention, norms, head); and with sequence
    parallelism (the tokens split between the products, the MoE block
    gathering them for its router)."""
    got, want, init = runs["two"][i], runs["one"][i], runs["specs"][i]["init"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    gg, gw = _grads(got, init), _grads(want, init)
    for k, w in gw.items():
        bar = 2e-5 * max(np.abs(w).max(), 1e-12)
        assert np.abs(gg[k] - w).max() <= bar, (name, k, np.abs(gg[k] - w).max(), bar)
    assert any(np.abs(w).max() > 0 for k, w in gw.items() if k.endswith("moe.router.weight"))


def test_tp_moe_refusals(runs):
    """Expert sharding with TP raises the JAX message (``pp_tp.py:272-276``),
    and so does an expert hidden dim that the 'model' axis does not divide
    (``:283-288``)."""
    ep, hidden = runs["errors"]
    assert ep == EP_TP_ERROR
    assert hidden == f"expert hidden 127 not divisible by model axis {W}"
