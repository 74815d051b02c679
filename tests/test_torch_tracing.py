"""The port's spans (``utils/profiling.span``) inside its train step, on the
CPU: off without a profiler session, their names, order, parents and step
ids under one, self time, and the Trainer's ``trace.json`` track.

A tiny AST (emb 32, depth 1, 2 heads, f32) on 0.5-s clips at 16 kHz, the
plain step, the step with two accumulated micro-batches and the indexed
step (gather from a pool)."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dlsc_tpu_torch.data.pipeline import DevicePipeline, PipelineConfig
from dlsc_tpu_torch.models.vit import ASTViT
from dlsc_tpu_torch.train.losses import CrossEntropyLoss
from dlsc_tpu_torch.train.metrics import MetricState
from dlsc_tpu_torch.train.optim import adam, cosine_annealing
from dlsc_tpu_torch.train.state import TrainState
from dlsc_tpu_torch.train.steps import make_train_step, make_train_step_indexed
from dlsc_tpu_torch.utils import profiling

C, B, T, SR = 4, 4, 8000, 16_000
FORMS = ["plain", "accum2", "indexed"]
PHASES = ["train.pipeline", "train.forward", "train.backward"]


def _step(form: str):
    """(a call running one train step of ``form``, the state it updates)."""
    gen = torch.Generator().manual_seed(0)
    model = ASTViT(num_classes=C, emb_dim=32, depth=1, num_heads=2, patch_size=16,
                   patch_stride=16, overlap=0, sample_rate=SR, generator=gen)
    pipe = DevicePipeline(PipelineConfig(mode="ast", num_classes=C, sample_rate=SR,
                                         time_mask=8, freq_mask=8, enable_mixup=True))
    state = TrainState.create(model, adam(1e-3), cosine_annealing(10), 4, 1.0, seed=0)
    ms = MetricState.create(C, torch.device("cpu"))
    rng = np.random.default_rng(0)
    pool = torch.from_numpy((rng.standard_normal((8, T)) * 0.3).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, C, 8))
    accum = 2 if form == "accum2" else 1
    if form == "indexed":
        step = make_train_step_indexed(pipe, CrossEntropyLoss())
        idx = torch.tensor([5, 1, 6, 2])
        return lambda: step(state, ms, pool, idx, labels.index_select(0, idx)), state
    step = make_train_step(pipe, CrossEntropyLoss(), accum)
    return lambda: step(state, ms, pool[:B], labels[:B]), state


def _expected(form: str) -> list[tuple[str, str | None]]:
    """(name, parent name) of one step's spans in the order they open."""
    micro = [(p, "train.step") for p in PHASES] * (2 if form == "accum2" else 1)
    return [("train.step", None), *micro, ("train.optimizer", "train.step")]


@pytest.mark.parametrize("form", FORMS)
def test_off_records_nothing_and_creates_no_event(form, monkeypatch):
    call, state = _step(form)
    created = []
    monkeypatch.setattr(torch.cuda, "Event", lambda *a, **k: created.append(1))
    monkeypatch.setattr(profiling, "_Open", lambda name: pytest.fail(f"span {name} on"))
    assert profiling.span("train.step") is profiling._OFF
    call()
    assert state.step == 1 and created == []


@pytest.mark.parametrize("form", FORMS)
def test_spans_under_a_profiler_session(form):
    call, _ = _step(form)
    call()   # before the session: not recorded
    with profile(activities=[ProfilerActivity.CPU]):
        call()
        call()
    got = profiling.spans()
    want = _expected(form) * 2
    assert [s.name for s in got] == [n for n, _ in want]
    assert [None if s.parent is None else got[s.parent].name for s in got] == \
        [p for _, p in want]
    per = len(want) // 2
    for k in range(2):   # one step id a step, shared by its spans, one per step
        ids = {s.step for s in got[k * per:(k + 1) * per]}
        assert len(ids) == 1
    assert got[0].step != got[per].step
    for s in got:
        assert s.host_ns[0] <= s.host_ns[1] and s.device_ms is None and s.records is None
        if s.parent is not None:
            p = got[s.parent]
            assert p.host_ns[0] <= s.host_ns[0] <= s.host_ns[1] <= p.host_ns[1]
    assert profiling.spans() == got   # reading again reads the same session
    with profile(activities=[ProfilerActivity.CPU]):
        call()
    assert [s.name for s in profiling.spans()] == [n for n, _ in _expected(form)]


def test_self_time_is_the_duration_less_the_children():
    mk = profiling.Span
    ss = [mk("a", 1, None, 1, (0, 100_000_000), (0.0, 90.0), None),
          mk("b", 1, 0, 1, (10_000_000, 30_000_000), (5.0, 25.0), None),
          mk("c", 1, 0, 1, (40_000_000, 70_000_000), (30.0, 80.0), None),
          mk("d", 1, 2, 1, (45_000_000, 50_000_000), (31.0, 32.0), None)]
    assert profiling.self_ms(ss, 0) == pytest.approx(100 - 20 - 30)
    assert profiling.self_ms(ss, 0, device=True) == pytest.approx(90 - 20 - 50)
    assert profiling.self_ms(ss, 2) == pytest.approx(30 - 5)
    assert profiling.self_ms(ss, 3, device=True) == pytest.approx(1.0)


def test_trace_json_holds_the_spans_as_their_own_track(tmp_path):
    call, _ = _step("plain")
    with profiling.trace(tmp_path / "prof"):
        call()
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
    track = [e for e in events if e.get("cat") == "span"]
    assert [e["name"] for e in track] == [n for n, _ in _expected("plain")]
    pids = {e["pid"] for e in track}
    assert len(pids) == 1
    pid = pids.pop()
    assert {e["pid"] for e in events if e.get("cat") != "span" and e.get("ph") != "M"} \
        .isdisjoint({pid})
    names = [e for e in events if e.get("ph") == "M" and e["pid"] == pid]
    assert names[0]["args"]["name"] == "dlsc_tpu_torch spans"
    # on the trace's clock: the ops of the step's body lie inside its span
    step, clock = track[0], next(e for e in events if e.get("name") == profiling.CLOCK)
    ops = [e for e in events if e.get("cat") == "cpu_op" and e["ts"] > step["ts"] - 1000]
    inside = [step["ts"] <= e["ts"] <= step["ts"] + step["dur"] for e in ops]
    assert sum(inside) > 100 and all(inside[inside.index(True):])
    assert clock["ts"] + clock["dur"] <= step["ts"]
