"""Tracing and profiling helpers.

The port's counterpart of ``dlsc_tpu/utils/profiling.py``:

- ``span(name)``: a span of the program's own work, recorded exactly while
  a ``torch.profiler`` session records (``train/steps.py`` opens
  ``train.step``, ``train.pipeline``, ``train.forward``, ``train.backward``
  and ``train.optimizer``); ``spans()`` reads them back, ``self_ms`` gives
  a span's self time;
- ``trace(dir)``: a ``torch.profiler`` capture (CPU and, where there is a
  card, CUDA activity) as a context manager; the Chrome trace is written to
  ``dir/trace.json`` on exit, with the spans as a track of their own;
- ``device_memory_stats``: the card's memory in use, its peak and its size
  (``torch.cuda.mem_get_info`` and ``torch.cuda.memory_stats``); empty
  without a card.

A span is off while no profiler session records
(``torch._C._autograd._profiler_enabled()`` is false): it costs that one
check. On, it records in memory its name, its thread, its parent, the id
of its step (the outermost span's, shared by every span opened inside it),
its host start and end on ``time.perf_counter_ns()`` and, where CUDA is
initialised, a pair of timing events recorded on the current stream. The
events come from a pool, filled in chunks by the first span that finds it
short, before that span's clock starts; a new event is recorded once as it
enters the pool, since CUDA creates an event at its first record. Every
event record of the recorder, the pool's included, is logged with the host
interval around it (``event_records()``): a trace whose host side holds
the CUDA runtime's calls pairs its ``cudaEventRecord*`` calls with them in
order, which puts each span on the trace's clock. A session's spans are
those recorded since the last ``spans()`` read: the first span after a
read clears the buffer (``trace()`` reads on exit).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import threading
import time
from pathlib import Path

import torch

_profiling = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()
POOL_CHUNK = 64   # events created at a time when the pool runs short
CLOCK = "dlsc_tpu_torch.clock"   # trace()'s annotation that anchors the spans' track


@dataclasses.dataclass(frozen=True)
class Span:
    """A closed span as ``spans()`` returns it."""

    name: str
    thread: int                      # ``threading.get_ident()`` of the thread that opened it
    parent: int | None               # index of the enclosing span in ``spans()``
    step: int                        # id of the outermost span it lies in
    host_ns: tuple[int, int]         # ``time.perf_counter_ns()`` at open and close
    device_ms: tuple[float, float] | None   # its events against the session's first on
    #                                         the same card; None without CUDA
    records: tuple[int, int] | None  # indices of its two event records in ``event_records()``

    @property
    def host_ms(self) -> float:
        return (self.host_ns[1] - self.host_ns[0]) / 1e6

    @property
    def dev_ms(self) -> float | None:
        return None if self.device_ms is None else self.device_ms[1] - self.device_ms[0]


class _Open:
    """A span being recorded: the context manager ``span()`` returns when on."""

    __slots__ = ("name", "thread", "parent", "step", "index", "t0", "t1", "device", "events",
                 "records")

    def __init__(self, name: str):
        self.name = name
        self.t1 = None

    def __enter__(self):
        _RECORDER.open(self)
        return self

    def __exit__(self, *exc) -> bool:
        _RECORDER.close(self)
        return False


class _Recorder:
    """The process's span buffer, event pool and event-record log."""

    def __init__(self):
        self.lock = threading.Lock()
        self.local = threading.local()
        self.buffer: list[_Open] = []
        self.records: list[tuple[int, int]] = []   # host interval of each event record
        self.pool: dict[int, list] = {}
        self.fresh = True   # the next outermost span starts a new buffer
        self.steps = 0

    def _stack(self) -> list:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack

    def _record(self, event) -> int:
        a = time.perf_counter_ns()
        event.record()
        b = time.perf_counter_ns()
        with self.lock:
            self.records.append((a, b))
            return len(self.records) - 1

    def _take(self, device: int) -> list:
        free = self.pool.setdefault(device, [])
        while len(free) < 2:
            for _ in range(POOL_CHUNK):
                ev = torch.cuda.Event(enable_timing=True)
                self._record(ev)   # creates it
                free.append(ev)
        return [free.pop(), free.pop()]

    def open(self, s: _Open) -> None:
        stack = self._stack()
        with self.lock:
            if not stack and self.fresh:
                for old in self.buffer:
                    if old.events is not None:
                        self.pool[old.device].extend(old.events)
                self.buffer, self.records, self.fresh = [], [], False
            if not stack:
                self.steps += 1
            s.parent = stack[-1].index if stack else None
            s.step = stack[-1].step if stack else self.steps
            s.index = len(self.buffer)
            self.buffer.append(s)
        s.thread = threading.get_ident()
        s.device = s.events = s.records = None
        if torch.cuda.is_initialized():
            s.device = torch.cuda.current_device()
            s.events = self._take(s.device)
        stack.append(s)
        s.t0 = time.perf_counter_ns()
        if s.events is not None:
            s.records = [self._record(s.events[0])]

    def close(self, s: _Open) -> None:
        if s.events is not None:
            s.records.append(self._record(s.events[1]))
        s.t1 = time.perf_counter_ns()
        stack = self._stack()
        if stack and stack[-1] is s:
            stack.pop()

    def read(self) -> list[Span]:
        with self.lock:
            buf, self.fresh = list(self.buffer), True
        if any(s.t1 is None for s in buf):
            raise RuntimeError("profiling.spans(): read while a span is open")
        first: dict[int, object] = {}
        for s in buf:
            if s.events is not None and s.device not in first:
                torch.cuda.synchronize(s.device)
                first[s.device] = s.events[0]
        return [Span(s.name, s.thread, s.parent, s.step, (s.t0, s.t1),
                     None if s.events is None else
                     tuple(first[s.device].elapsed_time(e) for e in s.events),
                     None if s.records is None else tuple(s.records))
                for s in buf]


_RECORDER = _Recorder()


def span(name: str):
    """``with span('train.forward'): ...``: a span of the program's work,
    recorded while a profiler session records (see the module docstring)."""
    if not _profiling():
        return _OFF
    return _Open(name)


def spans() -> list[Span]:
    """The spans of the session in the order they opened, after a
    synchronize of their cards; the next span recorded starts a new
    session."""
    return _RECORDER.read()


def event_records() -> list[tuple[int, int]]:
    """The host interval (``perf_counter_ns``) around each CUDA event record
    of the session's spans and of the pool's fill, in order."""
    with _RECORDER.lock:
        return list(_RECORDER.records)


def self_ms(all_spans: list[Span], i: int, device: bool = False) -> float:
    """Span ``i``'s duration (host, or device with ``device``) less the part
    of it that its children cover, in ms."""
    def interval(s):
        return (s.device_ms if device else (s.host_ns[0] / 1e6, s.host_ns[1] / 1e6))

    lo, hi = interval(all_spans[i])
    covered, end = 0.0, lo
    for a, b in sorted(interval(c) for c in all_spans if c.parent == i):
        a, b = max(a, end), min(b, hi)
        if b > a:
            covered += b - a
            end = b
    return hi - lo - covered


@contextlib.contextmanager
def trace(log_dir: str | Path):
    """Capture a trace: ``with trace(run_dir / 'profile'): step(...)``. The
    spans recorded inside go into ``trace.json`` as their own process
    track, on the trace's clock: the capture opens with an annotation
    (``CLOCK``) between two host clock readings, which anchors them."""
    path = Path(log_dir)
    path.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        _RECORDER.fresh = True
        with torch.profiler.record_function(CLOCK):
            pass
        clock_us = time.perf_counter_ns() / 1e3
        yield path
    out = path / "trace.json"
    prof.export_chrome_trace(str(out))
    _add_span_track(out, spans(), clock_us)


def _add_span_track(trace_json: Path, recorded: list[Span], clock_us: float) -> None:
    """Append ``recorded`` to a Chrome trace as a process of their own, a
    thread row per host thread, shifted by the ``CLOCK`` annotation whose
    end is ``clock_us`` on the host clock."""
    data = json.loads(Path(trace_json).read_text())
    events = data["traceEvents"]
    anchor = next((e for e in events if e.get("name") == CLOCK and e.get("ph") == "X"), None)
    if anchor is None:
        raise ValueError(f"{trace_json}: no {CLOCK!r} annotation to anchor the spans on")
    shift = anchor["ts"] + anchor["dur"] - clock_us
    pid = 1 + max((e["pid"] for e in events if isinstance(e.get("pid"), int)), default=0)
    tids = {t: k for k, t in enumerate(dict.fromkeys(s.thread for s in recorded), 1)}
    events.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                   "args": {"name": "dlsc_tpu_torch spans"}})
    for thread, tid in tids.items():
        events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                       "args": {"name": f"host thread {thread}"}})
    for i, s in enumerate(recorded):
        events.append({"ph": "X", "cat": "span", "name": s.name, "pid": pid,
                       "tid": tids[s.thread], "ts": s.host_ns[0] / 1e3 + shift,
                       "dur": s.host_ms * 1e3,
                       "args": {"index": i, "parent": s.parent, "step": s.step,
                                "device_ms": s.dev_ms}})
    Path(trace_json).write_text(json.dumps(data))


def device_memory_stats() -> dict:
    """{device name: {bytes_in_use, peak_bytes_in_use, bytes_limit}} per
    visible card; ``bytes_in_use`` is what the whole card has in use (this
    process's allocator and everything else), ``bytes_limit`` its size."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        free, total = torch.cuda.mem_get_info(i)
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": total - free,
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": total,
        }
    return out
