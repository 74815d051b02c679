"""The readers of the port's spans (``spans.py``, ``metrics/*_ms.train.py``,
``launches_per_step.train.py``): on a synthetic run whose trace holds the
record and launch calls at a known shift of the host clock, and without
spans; the ``gpu`` case aligns a span around one K3f call on the card."""

from __future__ import annotations

import pytest
import torch

from benchmark import harness, spans
from dlsc_tpu_torch.utils import profiling

SHIFT_US = -29_761_000.25   # the host clock onto the trace's, as the card read
MS = 1_000_000              # ns
PHASES = ("train.pipeline", "train.forward", "train.backward", "train.optimizer")
READERS = ("pipeline_ms.train", "forward_ms.train", "backward_ms.train", "optimizer_ms.train",
           "host_enqueue_ms.train", "launches_per_step.train")


def _synthetic(n_steps=2, extra_records=0, fill=3):
    """(spans, event records, trace) of ``n_steps`` steps of 100 ms on the
    host, each with four phases of 10, 20, 40 and 5 ms on the device and
    launches inside and between them; ``fill`` pool records come first, and
    ``extra_records`` record calls of something else sit between steps."""
    ss, records, calls, launches = [], [], [], []

    def rec(t_ns):
        records.append((t_ns, t_ns + 2_000))
        calls.append((t_ns + 1_000) / 1e3 + SHIFT_US)
        return len(records) - 1

    for k in range(fill):
        rec(k * 10_000)
    dev = 0.0
    for k in range(n_steps):
        t = 1 * MS + k * 120 * MS
        r0 = rec(t)
        step_index = len(ss)
        phase_spans, at, d = [], t + 5 * MS, dev + 1.0
        for name, dms in zip(PHASES, (10.0, 20.0, 40.0, 5.0)):
            p0 = rec(at)
            launches += [(at + 1 * MS) / 1e3 + SHIFT_US] * 3
            p1 = rec(at + 15 * MS)
            phase_spans.append(profiling.Span(name, 1, step_index, k + 1, (at, at + 15 * MS),
                                              (d, d + dms), (p0, p1)))
            at, d = at + 20 * MS, d + dms
        r1 = rec(t + 100 * MS)
        ss.append(profiling.Span("train.step", 1, None, k + 1, (t, t + 100 * MS),
                                 (dev, d + 2.0), (r0, r1)))
        ss += phase_spans
        dev = d + 3.0
        launches.append((t + 110 * MS) / 1e3 + SHIFT_US)   # between steps: not counted
        for j in range(extra_records):
            calls.append((t + 105 * MS + j * 1000) / 1e3 + SHIFT_US)
    host = ([("cudaEventRecordWithFlags", c, c + 1.0) for c in calls]
            + [("cudaLaunchKernel" if i % 2 else "cuLaunchKernelEx", t, t + 2.0)
               for i, t in enumerate(launches)]
            + [("cudaMemsetAsync", calls[0] + 5.0, calls[0] + 6.0)])
    trace = harness.Trace(device=[("k", 0.0, 1.0)], host=host, window_s=1.0, steps=n_steps)
    return ss, records, trace


def _run(monkeypatch, ss, records, trace):
    monkeypatch.setattr(profiling, "spans", lambda: ss)
    monkeypatch.setattr(profiling, "event_records", lambda: records)
    return harness.Run(None, "NVIDIA H100 80GB HBM3", {}, trace, ids=[])


@pytest.mark.parametrize("extra", [0, 2], ids=["paired_in_order", "paired_by_nearest"])
def test_readers_on_a_synthetic_run(extra, monkeypatch):
    ss, records, trace = _synthetic(extra_records=extra)
    run = _run(monkeypatch, ss, records, trace)
    got = {name: harness.reader(name)(run) for name in READERS}
    assert got == pytest.approx({"pipeline_ms.train": 10.0, "forward_ms.train": 20.0,
                                 "backward_ms.train": 40.0, "optimizer_ms.train": 5.0,
                                 "host_enqueue_ms.train": 100.0,
                                 "launches_per_step.train": 12.0})
    calls = [s for n, s, _ in trace.host if n.startswith(spans.RECORD)]
    at, shift = spans.pair(records, calls)
    assert shift == pytest.approx(SHIFT_US)
    assert [spans.on_trace(ss, records, trace)[0]] == pytest.approx(
        [(1 * MS / 1e3 + SHIFT_US + 1.0, 101 * MS / 1e3 + SHIFT_US + 1.0)])
    # the phases and the step's self time add up to the step's device time
    step = ss[0]
    phases = sum(s.dev_ms for s in ss[1:5])
    assert phases + profiling.self_ms(ss, 0, device=True) == pytest.approx(step.dev_ms)


def test_pairing_fails_loudly():
    ss, records, trace = _synthetic()
    calls = sorted(s for n, s, _ in trace.host if n.startswith(spans.RECORD))
    with pytest.raises(ValueError, match="event-record calls"):
        spans.pair(records, calls[:-1])
    bent = calls[:5] + [c + 500.0 for c in calls[5:]]   # a record 500 us off the shift
    with pytest.raises(ValueError, match="do not pair"):
        spans.pair(records, bent)


def test_readers_find_nothing_without_spans(monkeypatch):
    ss, records, trace = _synthetic()
    run = _run(monkeypatch, [], [], trace)
    assert all(harness.reader(name)(run) is None for name in READERS)
    on_cpu = [profiling.Span(s.name, s.thread, s.parent, s.step, s.host_ns, None, None)
              for s in ss]
    run = _run(monkeypatch, on_cpu, [], trace)   # no events: the device metrics read nothing
    assert {name: harness.reader(name)(run) for name in READERS} == {
        **{name: None for name in READERS}, "host_enqueue_ms.train": pytest.approx(100.0)}
    monkeypatch.delattr(profiling, "spans")      # a port without spans
    assert all(harness.reader(name)(run) is None for name in READERS)


@pytest.mark.gpu
def test_a_span_around_one_k3f_call_holds_its_launch_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: K3f and the event records run only on the card")
    from dlsc_tpu_torch.ops import ln_fused

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(3)
    x, delta = (torch.randn(8192, 768, device=dev, generator=g, dtype=torch.bfloat16)
                for _ in range(2))
    gamma, beta = torch.ones(768, device=dev), torch.zeros(768, device=dev)
    ln_fused.fused_add_ln_forward(x, delta, gamma, beta)   # build and warm

    def call():
        with profiling.span("k3f"):
            ln_fused.fused_add_ln_forward(x, delta, gamma, beta)

    trace = harness.profile(call, 3, dev)
    ss, records = profiling.spans(), profiling.event_records()
    assert [s.name for s in ss] == ["k3f"] * 3
    calls = [s for n, s, _ in trace.host if n.startswith(spans.RECORD)]
    at, shift = spans.pair(records, calls)
    for t, (a, b) in zip(at, records):   # each call within 20 us of its record's interval
        assert a / 1e3 - 20.0 <= t - shift <= b / 1e3 + 20.0
    kernels = sorted(s for n, s, _ in trace.device if "add_ln_fwd" in n)
    launch = sorted(s for n, s, _ in trace.host if n.startswith(spans.LAUNCH))
    assert len(kernels) == 3
    for (lo, hi) in spans.on_trace(ss, records, trace):
        inside = [t for t in launch if lo <= t <= hi]
        assert len(inside) == 1, (lo, hi, inside)
