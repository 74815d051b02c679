"""The spans the port records inside its train step, read by the per-layer
metrics of ``metrics/*_ms.train.py`` and ``launches_per_step.train.py``.

The port records them while a profiler session records
(``dlsc_tpu_torch.utils.profiling``: ``span``, ``spans()``,
``event_records()``); a version of the port without them gives these
metrics nothing to read. ``train.step`` spans the step's call,
``train.pipeline``, ``train.forward``, ``train.backward`` and
``train.optimizer`` its phases. A span's device interval is the time
between the two CUDA events it records on the step's stream; "a step" is
one ``train.step`` span.

The clock: the traced run records the device's activity and, on the host,
the CUDA runtime's calls. Each event record of the program is one
``cudaEventRecord*`` call there, in the same order (the port's train step
records no other event), so the i-th program record pairs with the i-th
call, and a span's interval on the trace's clock runs from the call of its
first record to that of its second. Where the trace holds more such calls
than the program made, each record pairs with the call nearest its host
time shifted by a first estimate, the shift that the most records find a
call at. Either way every pair must agree with
one shift of the host clock onto the trace's within ``TOL_US`` and the
records' own width, or the pairing fails with an error.
"""

from __future__ import annotations

import bisect
import statistics

STEP = "train.step"
RECORD = "cudaEventRecord"                          # prefix of the runtime's record calls
LAUNCH = ("cudaLaunchKernel", "cuLaunchKernel")     # prefixes of its kernel launches
TOL_US = 50.0


def recorded():
    """(the port's spans, its event records) of the traced steps, or None
    where it recorded none or has no spans."""
    try:
        from dlsc_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "spans"):
        return None
    ss = profiling.spans()
    if not any(s.name == STEP for s in ss):
        return None
    return ss, profiling.event_records()


def steps(ss) -> int:
    return sum(s.name == STEP for s in ss)


def device_ms_per_step(name: str) -> float | None:
    """Device ms a step of the spans called ``name``; None without spans or
    without their events (the CPU)."""
    got = recorded()
    if got is None or any(s.device_ms is None for s in got[0]):
        return None
    ss = got[0]
    return sum(s.dev_ms for s in ss if s.name == name) / steps(ss)


def host_ms_per_step() -> float | None:
    """Host ms a step inside ``train.step``: what the host takes to enqueue
    a step, waits on the device included."""
    got = recorded()
    if got is None:
        return None
    ss = got[0]
    return sum(s.host_ms for s in ss if s.name == STEP) / steps(ss)


def pair(records: list[tuple[int, int]], calls: list[float]) -> tuple[list[float], float]:
    """(the trace time in us of each program event record, the shift of the
    host clock onto the trace's in us). ``records``: host intervals in ns,
    in order; ``calls``: the starts of the trace's record calls in us."""
    calls = sorted(calls)
    n, m = len(records), len(calls)
    mids = [(a + b) / 2e3 for a, b in records]
    if m < n:
        raise ValueError(f"the trace holds {m} event-record calls for the program's {n}")
    if m == n:
        got = calls
    else:
        # first estimate: the shift that most records find a call at, the
        # i-th record's call lying among the i-th to the (i + m - n)-th
        diffs = sorted(calls[i + d] - mids[i] for i in range(n) for d in range(m - n + 1))
        lo, best = 0, (0, 0)
        for hi, v in enumerate(diffs):
            while v - diffs[lo] > TOL_US:
                lo += 1
            if hi - lo >= best[1] - best[0]:
                best = (lo, hi)
        shift0 = statistics.median(diffs[best[0]:best[1] + 1])
        got, j = [], 0
        for mid in mids:
            want = mid + shift0
            k = bisect.bisect_left(calls, want, lo=j)
            near = [c for c in (k - 1, k) if j <= c < m]
            if not near:
                raise ValueError("event records outnumber the calls left to pair with")
            c = min(near, key=lambda c: abs(calls[c] - want))
            got.append(calls[c])
            j = c + 1
    shift = statistics.median(t - mid for t, mid in zip(got, mids))
    bad = [i for i, (t, mid, (a, b)) in enumerate(zip(got, mids, records))
           if abs(t - mid - shift) > (b - a) / 2e3 + TOL_US]
    if bad:
        raise ValueError(f"{len(bad)} of {n} event records do not pair with the trace's "
                         f"{m} record calls within {TOL_US} us of one shift {shift:.1f} us")
    return got, shift


def on_trace(ss, records, trace) -> list[tuple[float, float] | None]:
    """Each span's (start, end) on the trace's clock, in us, by its two
    records' paired calls; None for a span without events."""
    calls = [s for n, s, _ in trace.host if n.startswith(RECORD)]
    at, _ = pair(records, calls)
    return [None if s.records is None else (at[s.records[0]], at[s.records[1]]) for s in ss]


def launches_per_step(run) -> float | None:
    """The trace's kernel-launch calls inside ``train.step`` spans, a step."""
    got = recorded()
    if got is None or run.trace is None or any(s.records is None for s in got[0]):
        return None
    ss, records = got
    span_at = on_trace(ss, records, run.trace)
    inside = sorted(iv for s, iv in zip(ss, span_at) if s.name == STEP)
    n = sum(1 for name, t, _ in run.trace.host if name.startswith(LAUNCH)
            and any(lo <= t <= hi for lo, hi in inside))
    return n / steps(ss)
