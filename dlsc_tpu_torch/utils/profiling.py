"""Tracing and profiling helpers.

The port's counterpart of ``dlsc_tpu/utils/profiling.py``:

- ``trace(dir)``: a ``torch.profiler`` capture (CPU and, where there is a
  card, CUDA activity) as a context manager; the Chrome trace is written to
  ``dir/trace.json`` on exit;
- ``Throughput``: a rolling clips/sec/chip meter, unchanged;
- ``device_memory_stats``: the card's memory in use, its peak and its size
  (``torch.cuda.mem_get_info`` and ``torch.cuda.memory_stats``); empty
  without a card.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch


@contextlib.contextmanager
def trace(log_dir: str | Path):
    """Capture a trace: ``with trace(run_dir / 'profile'): step(...)``."""
    path = Path(log_dir)
    path.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(str(path / "trace.json"))


class Throughput:
    """Rolling clips/sec/chip meter."""

    def __init__(self, n_chips: int = 1, window: int = 50):
        self.n_chips = max(n_chips, 1)
        self.window = window
        self._events: list[tuple[float, int]] = []

    def tick(self, n_clips: int) -> None:
        self._events.append((time.perf_counter(), n_clips))
        if len(self._events) > self.window:
            self._events.pop(0)

    @property
    def clips_per_sec_per_chip(self) -> float:
        if len(self._events) < 2:
            return 0.0
        dt = self._events[-1][0] - self._events[0][0]
        clips = sum(n for _, n in self._events[1:])
        return clips / dt / self.n_chips if dt > 0 else 0.0


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
