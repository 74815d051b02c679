"""The data-driven frame of a benchmark run: what ``BENCHMARK.json`` names is
found as files by that name, and what a run measured is reduced to the
result line.

- a cell's configuration is ``configs/<config>.json``, its traffic
  ``traffic/<traffic>.json``; the traffic's ``kind`` names the driver,
  ``drivers/<kind>.py``, that runs it (one general driver for every mix of a
  kind), and its correctness limits are ``limits/<cell>.json``;
- a per-layer metric is ``metrics/<name>.py``, whose ``read(run)`` returns
  a number or None (nothing to read: the metric is left out of the line);
- kernels are told apart by name fragments in ``layers/*.json``, read in
  the order of their file names, the first match winning.

A traced run's device numbers come from ``torch.profiler`` recording the
device's activity alone (with the host's ops recorded too, AST-MoE's
traced steps ran 10% longer than the window's, read as idle device time),
from a synchronized start: the busy time is the union of the device operations' intervals
(kernels overlapping on two streams count once), the window the host clock
around the profiled work, which ends in a synchronize. The host side of the
trace is the CUDA runtime's calls.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from typing import Any

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
BANNED = ("jax", "jaxlib", "flax", "dlsc_tpu")   # whole top-level module names
TOP = 10   # entries of each breakdown list


def load_json(path: Path) -> Any:
    return json.loads(Path(path).read_text())


def spec(root: Path = CHECKOUT) -> dict:
    return load_json(root / "BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with the files it names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]   # the metric entries this cell reports
    per_layer: list[dict]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, bench: dict | None = None, here: Path = HERE) -> Cell:
    """The cell ``name`` of ``bench`` (``BENCHMARK.json``) with its files."""
    bench = spec() if bench is None else bench
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; known: "
                         f"{[w['name'] for w in bench['workloads']]}")
    return Cell(name=name, chips=int(entry["chips"]),
                config=load_json(here / "configs" / f"{entry['config']}.json"),
                traffic=load_json(here / "traffic" / f"{entry['traffic']}.json"),
                limits=load_json(here / "limits" / f"{name}.json"),
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def load_module(path: Path, name: str):
    """The module of the file ``path``, imported under ``name``."""
    sp = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod


def driver(kind: str, here: Path = HERE):
    """``drivers/<kind>.py``: the general driver of a traffic kind."""
    return load_module(here / "drivers" / f"{kind}.py", f"benchmark_driver_{kind}")


def reader(metric: str, here: Path = HERE):
    """``metrics/<metric>.py``'s ``read``."""
    return load_module(here / "metrics" / f"{metric}.py",
                       "benchmark_metric_" + metric.replace(".", "_")).read


@dataclasses.dataclass(frozen=True)
class KernelId:
    kid: str
    layer: str
    match: tuple[str, ...]
    exclude: tuple[str, ...]


def kernel_ids(here: Path = HERE) -> list[KernelId]:
    """Every kernel id of ``layers/*.json``, in the order of the file names."""
    out = []
    for path in sorted((here / "layers").glob("*.json")):
        data = load_json(path)
        for kid, rule in data["kernels"].items():
            out.append(KernelId(kid, data["layer"], tuple(rule["match"]),
                                tuple(rule.get("exclude", ()))))
    return out


def classify(name: str, ids: list[KernelId]) -> str | None:
    """The first kernel id whose fragments match ``name``, or None."""
    for k in ids:
        if any(f in name for f in k.match) and not any(f in name for f in k.exclude):
            return k.kid
    return None


@dataclasses.dataclass
class Trace:
    """A profiled stretch: device operations and host ops as (name, start
    us, end us), the host-clock window in seconds and the work it held."""

    device: list[tuple[str, float, float]]
    host: list[tuple[str, float, float]]
    window_s: float
    steps: int = 0   # train steps (or serving calls) inside the window

    def busy_s(self) -> float:
        """The union of the device operations' intervals, in seconds."""
        total, end = 0.0, float("-inf")
        for s, e in sorted((s, e) for _, s, e in self.device):
            if e <= end:
                continue
            total += e - max(s, end)
            end = e
        return total / 1e6

    def seconds_of(self, kids: set[str], ids: list[KernelId]) -> float:
        """Device seconds of the operations classified as one of ``kids``."""
        return sum(e - s for n, s, e in self.device if classify(n, ids) in kids) / 1e6

    def gaps(self) -> list[tuple[float, float]]:
        """The idle stretches between the device operations, (start, end) us."""
        out, end = [], None
        for s, e in sorted((s, e) for _, s, e in self.device):
            if end is not None and s > end:
                out.append((end, s))
            end = e if end is None else max(end, e)
        return out

    def breakdown(self) -> dict:
        """The device operations that took most time, and the longest idle
        gaps named by the innermost host op running where each began."""
        by_name: dict[str, float] = {}
        for n, s, e in self.device:
            by_name[n[:120]] = by_name.get(n[:120], 0.0) + (e - s) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:TOP]
        named = []
        for s, e in gaps:
            inside = [(hs, n) for n, hs, he in self.host if hs <= s < he]
            named.append([max(inside)[1][:120] if inside else "host: outside CUDA calls",
                          (e - s) / 1e6])
        return {"device_ops": [[n, t] for n, t in ops], "idle_gaps": named}


def sync(device) -> None:
    """Wait for ``device`` (a CUDA one; nothing to wait for on the CPU)."""
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device, reset: bool = False) -> int:
    """``torch.cuda.max_memory_allocated`` (0 on the CPU), then reset it."""
    import torch

    if device.type != "cuda":
        return 0
    peak = torch.cuda.max_memory_allocated(device)
    if reset:
        torch.cuda.reset_peak_memory_stats(device)
    return peak


def trace_of(prof, window_s: float, steps: int = 0) -> Trace:
    """The ``Trace`` of a stopped ``torch.profiler`` session whose window is
    the last ``window_s`` seconds before its last device operation ended:
    operations that ran before it (work queued before the session began)
    are cut off at its start."""
    import torch

    dev, host = [], []
    for evt in prof.events():
        row = (evt.name, float(evt.time_range.start), float(evt.time_range.end))
        (dev if evt.device_type == torch.autograd.DeviceType.CUDA else host).append(row)
    if dev:
        start = max(e for _, _, e in dev) - window_s * 1e6
        dev = [(n, max(s, start), e) for n, s, e in dev if e > start]
    return Trace(dev, host, window_s, steps)


def profiler():
    """A ``torch.profiler`` session of the device's activity alone (the
    host's ops where no CUDA device is there: the CPU tests). No schedule:
    after a warm-up phase of the profiler, AST-Base's recorded kernels ran
    7% longer on the H100 than in the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile as _profile

    act = ProfilerActivity.CUDA if torch.cuda.is_available() else ProfilerActivity.CPU
    return _profile(activities=[act])


def profile(fn, steps: int, device) -> Trace:
    """``fn()`` ``steps`` times under the profiler, synchronized before and
    after; the window is the host clock over the calls."""
    import time

    sync(device)
    with profiler() as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        sync(device)
        window = time.perf_counter() - t0
    return trace_of(prof, window, steps)


@dataclasses.dataclass
class Run:
    """What a per-layer reader sees of a run: the cell's files, the card's
    name, host-clock numbers of the driver (``host``) and the trace."""

    cell: Cell
    device_name: str
    host: dict
    trace: Trace | None
    ids: list[KernelId] = dataclasses.field(default_factory=kernel_ids)

    def kernel_seconds(self, *kids: str) -> float:
        return 0.0 if self.trace is None else self.trace.seconds_of(set(kids), self.ids)

    def idle_percent(self) -> float | None:
        """The device's idle share of the traced window, or None untraced."""
        if self.trace is None or not self.trace.device:
            return None
        return 100.0 * (1.0 - self.trace.busy_s() / self.trace.window_s)


def banned_modules() -> list[str]:
    """Loaded modules whose whole top-level name is a JAX one."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in BANNED)
