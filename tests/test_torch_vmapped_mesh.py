"""The vmapped HPO's trials over several ranks (``hpo/vmapped.py``'s
``plan``, the JAX runner's ``plan=``, ``dlsc_tpu/hpo/vmapped.py:196``,
``:363-397``) on 2 gloo ranks against the port's one-process study, and the
sharded CLI.

One spawn of 2 ranks for the file (``tests/dist_workers.vmapped_study``):
``run_batch(k=4)`` and ``run_continuous(k=4, total_trials=6)`` of a tiny
ViT (width 32, depth 2, 2 heads) with per-trial dropout and mixup α,
2 epochs, TPE and Hyperband; each rank trains 2 of the 4 slots. Bars:
exact. The per-epoch train and validation accuracies, the trial numbers,
params, states, values and intermediate values, and each rank's stacked
parameters, Adam moments, step counts and buffers equal the one-process
run's (its slots [2r, 2r + 2) for rank r) bit for bit: a trial's init,
pipeline draws and dropout masks are keyed by its global slot, no
collective runs inside a step, and both sides run one intra-op thread.
The one-process run is held to the JAX runner by ``tests/test_torch_vmapped.py``
(``test_run_batch_matches_jax``, ``test_run_continuous_matches_jax``),
and the JAX runner's sharded run equals its unsharded one
(``tests/test_vmapped_hpo.py:130``). A K that is not a multiple of the
ranks raises the JAX message (``:392-397``).
"""

import numpy as np
import pytest
import torch

from dlsc_tpu_torch import hpo
from dlsc_tpu_torch.data.synthetic import make_synthetic_dataset
from dlsc_tpu_torch.parallel import spawn
from tests import dist_workers as dw

W, K = 2, 4
NUM_CLASSES = 10
VIT = dict(num_classes=NUM_CLASSES, emb_dim=32, depth=2, num_heads=2, patch_size=16,
           patch_stride=16, overlap=0, dropout=0.1, dtype="float32")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("mshards")
    make_synthetic_dataset(root, num_classes=NUM_CLASSES, clips_per_class_per_fold=2,
                           clip_samples=8000)
    dm = dict(num_classes=NUM_CLASSES, fold=0, val_split=0.2, batch_size=16,
              preprocessing_mode="ast", is_spectrogram=True, enable_mixup=True)
    base = dict(fn="vmapped_study", root=str(root), dm=dm, model_kw=VIT, k=K)
    specs = [dict(base, mode="batch", name="b"), dict(base, mode="continuous", total=6,
                                                      name="c")]

    def with_db(tag):
        return [dict(s, db=str(root / f"{tag}-{s['name']}.db")) for s in specs]

    refusal = dict(base, mode="batch", name="r", db=str(root / "r.db"), k=3, refusal=True)
    two = spawn(dw.run_all, W, with_db("two") + [refusal], timeout_s=600)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)   # as the ranks run
    try:
        one = dw.run_all(with_db("one"))
    finally:
        torch.set_num_threads(threads)
    return dict(two=[r[:2] for r in two], refusal=two[0][2], one=one)


def _equal_trials(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[:4] == w[:4] or (np.isnan(g[3]) and np.isnan(w[3]) and g[:3] == w[:3])
        if len(w) > 4:
            assert g[4] == w[4]


def test_run_batch_over_two_ranks_matches_one_process(runs):
    """``run_batch``: every rank holds the global history, values and trial
    numbers; rank r's states are the slots [2r, 2r + 2) of the one-process
    states; rank 0's study holds the one-process study's trials."""
    want = runs["one"][0]
    for r in range(W):
        got = runs["two"][r][0]
        assert got["history"] == want["history"]
        np.testing.assert_array_equal(got["values"], want["values"])
        assert got["numbers"] == want["numbers"]
        mine = slice(r * K // W, (r + 1) * K // W)
        for name in ("flat", "mu", "nu", "count"):
            np.testing.assert_array_equal(got[name], want[name][mine], err_msg=name)
        for name, b in want["buffers"].items():
            np.testing.assert_array_equal(got["buffers"][name], b[mine], err_msg=name)
    _equal_trials(runs["two"][0][0]["trials"], want["trials"])
    rates = [b for n, b in want["buffers"].items() if n.endswith("hyper_rate")]
    assert rates and len(np.unique(rates[0])) == K   # per-trial dropout ran


def test_run_continuous_over_two_ranks_matches_one_process(runs):
    """``run_continuous``: the finished trials (the recycled slots' among
    them) and rank 0's study equal the one-process run's."""
    want = runs["one"][1]
    for r in range(W):
        _equal_trials(runs["two"][r][1]["finished"], want["finished"])
    _equal_trials(runs["two"][0][1]["trials"], want["trials"])
    assert len(want["trials"]) == 6


def test_k_not_a_multiple_of_the_ranks_raises(runs):
    assert runs["refusal"] == (f"k=3 trials must be a multiple of the mesh data axis ({W}) "
                               "for mesh-sharded trial parallelism")


def test_sharded_vmapped_cli(tmp_path, monkeypatch):
    """``optimize_hyperparams +optuna.vmapped.mesh=true`` with
    ``trainer.devices=2`` on the CPU starts 2 gloo ranks (one trial of the 2
    slots each) and writes one study of the configured 3 trials."""
    from dlsc_tpu_torch.scripts import optimize_hyperparams

    root = tmp_path / "data"
    make_synthetic_dataset(root, num_classes=4, clips_per_class_per_fold=2,
                           clip_samples=16_000, seed=1)
    monkeypatch.setenv("DLSC_TRACKING_DIR", str(tmp_path / "runs"))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")   # the ranks' intra-op threads
    study = optimize_hyperparams.main([
        "model=ast", "trainer.accelerator=cpu", "trainer.devices=2", f"dataset.root={root}",
        "dataset.num_classes=4", "+model.emb_dim=32", "+model.depth=2", "+model.num_heads=2",
        "batch_size=8", "trainer.max_epochs=2", "optuna.n_trials=3",
        f"optuna.storage_path=sqlite:///{tmp_path / 'study.db'}",
        f"optuna.output_dir={tmp_path / 'out'}", "+optuna.vmapped.enabled=true",
        "+optuna.vmapped.k=2", "+optuna.vmapped.mesh=true",
        "+optuna.vmapped.spaces={model.dropout: {low: 0.0, high: 0.5}}"])
    assert len(study.trials) == 3
    assert {t.state for t in study.trials} <= {hpo.TrialState.COMPLETE, hpo.TrialState.PRUNED}
    assert all(t.intermediate_values and "model.dropout" in t.params for t in study.trials)
