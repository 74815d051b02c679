"""The benchmark's harness, yardstick and reference, on the CPU at tiny
sizes; the ``gpu`` cases run on a card and skip without one."""

from __future__ import annotations

import copy
import dataclasses
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import checks, flops, harness, inputs
from benchmark.reference import philox
from conftest import ROOT, tiny_cell


def _execute(cell, device, hooks=None, seed=2**31 + 977, seconds=0.5):
    from benchmark import run as R

    return R.execute(cell, seed, seconds, False, device, hooks)


# ---- files found by name ---------------------------------------------------------------

def test_new_files_are_found_by_name(tmp_path):
    for sub in ("configs", "traffic", "limits", "metrics", "layers", "drivers"):
        (tmp_path / sub).mkdir()
    (tmp_path / "configs" / "cfg_x.json").write_text(json.dumps({"model": {"emb_dim": 8}}))
    (tmp_path / "traffic" / "mix_x.json").write_text(json.dumps({"kind": "kind_x"}))
    (tmp_path / "limits" / "cfg_x.mix_x.json").write_text(json.dumps({"gap": {"limit": 0.5}}))
    (tmp_path / "metrics" / "thing_x.train.py").write_text("def read(run):\n    return 42.0\n")
    (tmp_path / "drivers" / "kind_x.py").write_text("def run(ctx):\n    return 'ran'\n")
    (tmp_path / "layers" / "a_first.json").write_text(json.dumps(
        {"layer": "kernels", "kernels": {"KA": {"match": ["gmm"], "exclude": ["tgmm"]}}}))
    (tmp_path / "layers" / "b_second.json").write_text(json.dumps(
        {"layer": "kernels", "kernels": {"KB": {"match": ["tgmm", "gmm"]}}}))
    bench = {"workloads": [{"name": "cfg_x.mix_x", "config": "cfg_x", "traffic": "mix_x",
                            "chips": 1, "why": "w"}],
             "end_to_end": [{"name": "setup_s"}, {"name": "other", "workloads": ["z"]}],
             "per_layer": [{"name": "thing_x.train", "workloads": ["cfg_x.mix_x"]}]}
    cell = harness.find_cell("cfg_x.mix_x", bench, tmp_path)
    assert cell.config["model"]["emb_dim"] == 8 and cell.traffic["kind"] == "kind_x"
    assert cell.limits["gap"]["limit"] == 0.5
    assert [m["name"] for m in cell.end_to_end] == ["setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["thing_x.train"]
    assert harness.reader("thing_x.train", tmp_path)(None) == 42.0
    assert harness.driver("kind_x", tmp_path).run(None) == "ran"
    ids = harness.kernel_ids(tmp_path)
    assert harness.classify("gmm_bf16_wgmma_kernel", ids) == "KA"
    assert harness.classify("tgmm_bf16_wgmma_kernel", ids) == "KB"
    assert harness.classify("nvjet_tst", ids) is None


def test_every_named_file_of_the_benchmark_exists():
    bench = harness.spec()
    for w in bench["workloads"]:
        cell = harness.find_cell(w["name"], bench)
        assert cell.traffic["kind"] in ("train", "serve")
        for m in cell.per_layer:
            assert callable(harness.reader(m["name"]))
    ids = {k.kid for k in harness.kernel_ids()}
    assert {"K1", "K2f", "K2b", "K4a", "K4b", "draw"} <= ids


def test_kernel_names_of_the_port_classify():
    ids = harness.kernel_ids()
    names = {"(anonymous namespace)::attn_fwd_bf16_kernel(CUtensorMap_st)": "K2f",
             "(anonymous namespace)::attn_bwd_dkv_bf16_kernel(CUtensorMap_st)": "K2b",
             "(anonymous namespace)::attn_bwd_dq_bf16_kernel(CUtensorMap_st)": "K2b",
             "void gmm_bf16_wgmma_kernel<1>(CUtensorMap_st)": "K4a",
             "void tgmm_bf16_wgmma_kernel<1>(CUtensorMap_st)": "K4b",
             "tgmm_reduce_kernel(float const*)": "K4b",
             "void dropout_draw_kernel<true>(Params)": "draw",
             "void mel_power_kernel<512>(float const*)": "K1"}
    for name, kid in names.items():
        assert harness.classify(name, ids) == kid, name


def test_trace_union_gaps_and_breakdown():
    t = harness.Trace(device=[("a", 0.0, 10.0), ("b", 5.0, 20.0), ("a", 30.0, 40.0)],
                      host=[("op_outer", 15.0, 35.0), ("op_inner", 19.0, 31.0)],
                      window_s=50e-6, steps=1)
    assert t.busy_s() == pytest.approx(30e-6)
    assert t.gaps() == [(20.0, 30.0)]
    b = t.breakdown()
    assert b["device_ops"][0] == ["a", pytest.approx(20e-6)]
    assert b["idle_gaps"] == [["op_inner", pytest.approx(10e-6)]]


def test_trace_keeps_the_recorded_window():
    """Device operations of the profiler's warm-up calls that ran before the
    recorded window are cut off; the window ends at the last operation."""
    cuda = torch.autograd.DeviceType.CUDA

    def evt(name, s, e, dev=cuda):
        return type("E", (), {"name": name, "device_type": dev,
                              "time_range": type("R", (), {"start": s, "end": e})})

    class Prof:
        def events(self):
            return [evt("warm", 0.0, 50.0), evt("edge", 80.0, 120.0), evt("k", 130.0, 200.0),
                    evt("cudaLaunchKernel", 125.0, 126.0, torch.autograd.DeviceType.CPU)]

    t = harness.trace_of(Prof(), 100e-6, steps=2)
    assert [n for n, _, _ in t.device] == ["edge", "k"]
    assert t.busy_s() == pytest.approx(90e-6)
    assert t.host == [("cudaLaunchKernel", 125.0, 126.0)]


def test_idle_is_the_traced_busy_time_over_the_window():
    """1 - busy per traced step / the untraced window's wall per step."""
    t = harness.Trace(device=[("k", 0.0, 80.0), ("k", 100.0, 180.0)], host=[],
                      window_s=400e-6, steps=2)
    run = harness.Run(None, "cpu", {"steps": 10, "window_s": 1e-3}, t, ids=[])
    assert harness.reader("device_idle.train")(run) == pytest.approx(20.0)
    assert harness.reader("device_idle.train")(harness.Run(None, "cpu", run.host, None,
                                                           ids=[])) is None


# ---- the yardstick's arithmetic --------------------------------------------------------

def _model(name):
    return harness.load_json(harness.HERE / "configs" / f"{name}.json")["model"]


def test_token_counts():
    assert flops.token_counts(_model("ast_base"), 220_500) == (1645, 1664)
    assert flops.token_counts(_model("ast_moe"), 220_500) == (689, 768)


def test_step_flops_give_the_measured_mfu_of_batch_64():
    # PR 11's AST-Base step on the H100: 331.853 ms at batch 64 read 23.2% MFU
    per_clip = flops.step_flops_per_clip(_model("ast_base"), 1645)
    assert 64 * per_clip / 0.331853 / 989e12 == pytest.approx(0.232, abs=5e-4)


def test_step_flops_by_hand():
    m = {"emb_dim": 4, "depth": 1, "mlp_ratio": 2.0, "patch_size": 2, "num_classes": 3,
         "moe": None}
    n = 5
    patch = 4 * 4 * 4 * 2            # (n - 1) patches · 2·2 pixels · D · 2
    blocks = (4 * 16 * 2 + 2 * 2 * 16 * 2) * n
    head = 4 * 3 * 2
    attn = 4 * n * n * 4
    assert flops.step_flops_per_clip(m, n) == 3 * (patch + blocks + head) + 3.5 * attn
    moe = {**m, "moe": {"top_k": 2, "n_experts": 3}}
    blocks_moe = (4 * 16 * 2 + 2 * (2 * 2 * 16 * 2) + 2 * 4 * 3) * n
    assert flops.step_flops_per_clip(moe, n) == 3 * (patch + blocks_moe + head) + 3.5 * attn


def test_kernel_work_by_hand():
    m = {"emb_dim": 128, "num_heads": 2, "depth": 1}
    f, b = flops.attention_work(m, 1, 10)
    assert f == 14 * 100 * 128
    act, row = 10 * 128 * 2, 2 * 10 * 4
    assert b == (4 * act + row) + (8 * act + 2 * row)
    g = {"emb_dim": 4, "depth": 1, "mlp_ratio": 4.0, "moe": {"n_experts": 2, "top_k": 1}}
    f, b = flops.grouped_matmul_work(g, 1, 3)
    assert f == 6 * 2 * 3 * 4 * 16
    assert b == 6 * 60 * 2 + 6 * (2 * 4 * 16 * 2)
    assert flops.least_seconds(989e12, 0.0, "NVIDIA H100 80GB HBM3") == pytest.approx(1.0)
    assert flops.least_seconds(0.0, 3.35e12, "NVIDIA H100 80GB HBM3") == pytest.approx(1.0)
    with pytest.raises(ValueError):
        flops.peaks("cpu")


# ---- inputs from the seed --------------------------------------------------------------

def test_open_loop_schedule_is_the_seeds():
    seed = 2**31 + 7
    a, b = inputs.arrivals(400.0, 30.0, seed), inputs.arrivals(400.0, 30.0, seed)
    assert len(a) == 12_000 and np.array_equal(a, b)
    assert np.all(np.diff(a) >= 0) and a[0] >= 0 and a[-1] < 30.0
    other = inputs.arrivals(400.0, 30.0, seed + 1)
    assert len(other) == 12_000 and not np.array_equal(a, other)
    assert np.array_equal(inputs.request_clips(50, 256, seed), inputs.request_clips(50, 256, seed))


def test_train_feed_is_the_seeds():
    seed = 2**33 + 5
    rows = [inputs.order(i, 1600, 128, seed) for i in range(12)]
    assert len(np.unique(np.concatenate(rows))) == 1536   # one epoch: all rows differ
    assert np.array_equal(inputs.order(3, 1600, 128, seed), rows[3])
    p = {"time_mask": 192, "freq_mask": 48, "n_mels": 128, "enable_mixup": True,
         "mixup_alpha": 0.5}
    d1, d2 = inputs.draws(2, 128, 1379, p, seed), inputs.draws(2, 128, 1379, p, seed)
    assert all(np.array_equal(getattr(d1, f.name), getattr(d2, f.name))
               for f in dataclasses.fields(d1))
    assert np.all(d1.partner != np.arange(128))
    w1 = inputs.weights(_model("ast_moe") | {"depth": 1}, seed, "cpu")
    w2 = inputs.weights(_model("ast_moe") | {"depth": 1}, seed, "cpu")
    assert all(torch.equal(w1[k], w2[k]) for k in w1)


# ---- the reference against the port ----------------------------------------------------

def test_philox_is_the_ports_draw():
    from dlsc_tpu_torch.ops.dropout_draw import keep_mask

    shape = (3, 7, 24)
    for seed, block, site in ((2**62 + 5, 3, 1), (12345, 0, 2)):
        mine = philox.keep_mask(torch.arange(np.prod(shape)), 0.1, block, site,
                                seed).reshape(shape)
        assert torch.equal(mine, keep_mask(shape, 0.1, seed, block, site))


def test_features_are_the_ports(cpu):
    from benchmark.drivers.train import port_pipeline
    from benchmark.reference import features as feats

    cfg = harness.find_cell("ast_base.train_b128").config
    wave = inputs.clips(3, 22_050, 44_100, 11, cpu)
    mine = feats.features(wave, 44_100, cfg["pipeline"])
    port = port_pipeline(cfg).eval_batch(wave)
    assert mine.shape == port.shape
    assert torch.allclose(mine, port, atol=2e-4, rtol=0)


@pytest.mark.parametrize("name", ["ast_base.train_b128", "ast_moe.train_b256"])
def test_reference_is_the_port_in_f32(name, cpu):
    """The port run in f32 (its plain kernels on the CPU) against the
    reference: three steps with dropout, MoE routing and aux loss, clip and
    Adam agree to rounding, and the reference routes every token as the
    program did."""
    cell = tiny_cell(name)
    cell.config["model"]["dtype"] = "float32"
    out, line = _execute(cell, cpu)
    for k, c in line["checks"].items():
        assert c["value"] < 1e-4, (k, c)
    assert out["correct"]


def test_route_replay_is_exact(cpu):
    """The reference replaying its own routes reads what it reads free."""
    from benchmark.drivers import train as D

    cell = tiny_cell("ast_moe.train_b256")
    free = D.reference(cell.config, cell.traffic, 11, cpu)
    again = D.reference(cell.config, cell.traffic, 11, cpu, routes=free["routes"])
    assert again["route_flip_share"] == 0.0
    assert again["losses"] == free["losses"] and again["grad"] == free["grad"]


def test_serving_reference_is_the_port(cpu):
    out, line = _execute(tiny_cell("ast_base.serve_b16"), cpu, seconds=1.0)
    assert out["failed"] == 0 and out["attempted"] == 20
    assert line["correct"], line["checks"]


# ---- what the comparison must catch ----------------------------------------------------

@pytest.mark.parametrize("name", ["ast_base.train_b128", "ast_moe.train_b256"])
def test_control_in_fp8_is_not_correct(name, cpu):
    """The reference computed in fp8, put in the program's place, fails one
    of the cell's limits."""
    from benchmark.drivers import train as D

    cell = tiny_cell(name)
    seed = 2**31 + 4099
    fp8 = D.reference(cell.config, cell.traffic, seed, cpu, prec="fp8")
    f32 = D.reference(cell.config, cell.traffic, seed, cpu, routes=fp8.get("routes"))
    ok, _ = checks.judge(checks.train_readings(fp8, f32), cell.limits)
    assert not ok


def _state_unchanged(step):
    def f(state, ms, pool, idx, labels, **kw):
        saved = [p.detach().clone() for p in state.model.parameters()]
        out = step(state, ms, pool, idx, labels, **kw)
        with torch.no_grad():
            for p, s in zip(state.model.parameters(), saved):
                p.copy_(s)
        return out
    return f


def _half_batch(step):
    from dlsc_tpu_torch.data.pipeline import TrainDraws
    from dlsc_tpu_torch.ops.augment import MixupDraws, SpecAugmentDraws

    def f(state, ms, pool, idx, labels, draws, dropout_seed):
        h = len(idx) // 2
        s, mx = draws.spec, draws.mix
        d = TrainDraws(SpecAugmentDraws(*(getattr(s, k.name)[:h] for k in
                                          dataclasses.fields(s))),
                       MixupDraws(mx.gate[:h], mx.lam[:h], mx.partner[:h] % h))
        return step(state, ms, pool, idx[:h], labels[:h], draws=d, dropout_seed=dropout_seed)
    return f


@pytest.mark.parametrize("name", ["ast_base.train_b128", "ast_moe.train_b256"])
@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch])
def test_faulty_train_step_is_not_correct(name, fault, cpu):
    out, line = _execute(tiny_cell(name), cpu, {"train_step": fault})
    assert out["correct"] is False, line["checks"]


def test_misrouted_tokens_are_not_correct(cpu):
    """A router that swaps its second choice for its third on 4% of the
    tokens, through the port's own ``topk`` option of its train step: the
    reference replays the routes of the program's gates, so the dispatch
    check itself catches it."""
    from benchmark import faults

    out, line = _execute(tiny_cell("ast_moe.train_b256"), cpu, faults.misrouted_topk())
    assert line["checks"]["route_topk_gap"]["value"] > 0.0
    assert out["correct"] is False, line["checks"]


def test_int8_serving_is_not_correct(cpu):
    """The port's own int8 serving path (w8a8) in the bf16 program's place,
    the serving cell's control, fails one of its limits."""
    from benchmark import faults

    cell = tiny_cell("ast_base.serve_b16")
    cell.traffic["rate_per_s"] = 80.0
    out, line = _execute(cell, cpu, faults.w8a8(cpu), seconds=1.0)
    assert out["correct"] is False, line["checks"]


def test_altered_answers_are_not_correct(cpu):
    def rotated(serve):
        return lambda wave: np.roll(serve(wave), 1, axis=0)

    cell = tiny_cell("ast_base.serve_b16")
    cell.traffic["rate_per_s"] = 80.0   # batches of several requests
    out, line = _execute(cell, cpu, {"serve": rotated}, seconds=1.0)
    assert out["correct"] is False, line["checks"]


# ---- nothing of JAX, and a reference that stands alone -----------------------------------

def _modules_after(code: str) -> dict:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=600, env={"PATH": "/usr/bin:/bin",
                                                     "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_nothing_of_jax():
    code = (
        "import sys, json, torch\n"
        "sys.path.insert(0, 'benchmark/tests')\n"
        "from conftest import tiny_cell\n"
        "from benchmark import run as R, harness\n"
        "R.execute(tiny_cell('ast_moe.train_b256'), 3, 0.2, True, torch.device('cpu'))\n"
        "R.execute(tiny_cell('ast_base.serve_b16'), 3, 0.5, False, torch.device('cpu'))\n"
        "print(json.dumps({'banned': harness.banned_modules(),"
        " 'port': 'dlsc_tpu_torch' in sys.modules}))\n")
    got = _modules_after(code)
    assert got == {"banned": [], "port": True}


def test_reference_loads_nothing_of_the_port():
    code = (
        "import sys, json\n"
        "import benchmark.reference.train, benchmark.reference.vit\n"
        "import benchmark.reference.features, benchmark.reference.philox\n"
        "import benchmark.checks, benchmark.flops, benchmark.inputs\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules}"
        " & {'dlsc_tpu_torch', 'dlsc_tpu', 'jax', 'jaxlib', 'flax'})))\n")
    assert _modules_after(code) == []


def test_banned_names_compare_whole():
    sys.modules.setdefault("dlsc_tpu_torch_lookalike_x", type(sys)("x"))
    try:
        assert "dlsc_tpu_torch_lookalike_x" not in harness.banned_modules()
    finally:
        sys.modules.pop("dlsc_tpu_torch_lookalike_x", None)


# ---- on the card ------------------------------------------------------------------------

@pytest.mark.gpu
def test_philox_is_the_kernels_draw_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the dropout kernel runs only on the card")
    from dlsc_tpu_torch.ops.dropout_draw import keep_mask

    shape = (5, 129, 1536)
    dev = torch.device("cuda", 0)
    g = torch.arange(int(np.prod(shape)), device=dev)
    mine = philox.keep_mask(g, 0.1, 7, 1, 2**61 + 3).reshape(shape)
    assert torch.equal(mine, keep_mask(shape, 0.1, 2**61 + 3, 7, 1, device=dev))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["ast_base.train_b128", "ast_moe.train_b256"])
def test_reference_is_the_port_in_f32_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the port's kernels run only on the card")
    cell = tiny_cell(name)
    cell.config["model"]["dtype"] = "float32"
    torch.backends.cuda.matmul.allow_tf32 = False
    out, line = _execute(cell, torch.device("cuda", 0))
    for k, c in line["checks"].items():
        assert c["value"] < 1e-3, (k, c)


def test_limits_lie_between_their_readings():
    """Above the lower reading and below the upper one; an exact comparison
    reads 0 when sound and has the limit 0."""
    for path in sorted((harness.HERE / "limits").glob("*.json")):
        for name, lim in harness.load_json(path).items():
            exact = lim["lower"] == lim["limit"] == 0.0
            assert exact or lim["lower"] < lim["limit"], (path.name, name)
            assert lim["limit"] < lim["upper"], (path.name, name)
