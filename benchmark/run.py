"""One run of one benchmark cell of the port ``dlsc_tpu_torch``:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It loads, warms up, measures for ``--seconds``
and prints, as the last line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number that decided
``correct`` beside its limit, which also close standard error.

It exits with a code other than 0, and prints no result, when no CUDA
device is there or fewer than the cell asks for, and when a module whose
top-level name is ``jax``, ``jaxlib``, ``flax`` or ``dlsc_tpu`` is loaded
once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# build and kernel caches at fixed paths inside the checkout (the port builds its
# own kernels into build/dlsc_tpu_torch/ there)
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(ROOT / "build" / "benchmark_cache" / sub)
os.environ["USE_FLAX"] = "0"
sys.path[:] = [str(ROOT)] + [p for p in sys.path if Path(p or ".").resolve() != HERE]


@dataclasses.dataclass
class Context:
    """What a driver is given: the cell, the run's arguments, the device,
    the process's start on the host clock and, for tests, hooks that replace
    parts of the timed path."""

    cell: object
    seed: int
    seconds: float
    trace: bool
    device: object
    t_start: float
    hooks: dict = dataclasses.field(default_factory=dict)

    @staticmethod
    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"


def result_line(cell, out: dict, trace: bool, device: dict) -> dict:
    """The contract's JSON object from a driver's outcome."""
    from benchmark import harness

    if trace:
        run = harness.Run(cell, device["kind"], out["host"], out["trace"])
        metrics = {}
        for m in cell.per_layer:
            v = harness.reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out["metrics"][m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    line = {"correct": bool(out["correct"]), "attempted": int(out["attempted"]),
            "failed": int(out["failed"]), "metrics": metrics, "device": device}
    if trace and out["trace"] is not None:
        t = out["trace"]
        device.update(busy_s=t.busy_s(), window_s=t.window_s)
        line["breakdown"] = t.breakdown()
    line["checks"] = out["checks"]
    return line


def execute(cell, seed: int, seconds: float, trace: bool, device, hooks=None) -> tuple:
    """Run ``cell`` once on ``device``: (the driver's outcome, its result line)."""
    import torch

    from benchmark import harness

    ctx = Context(cell, seed, seconds, trace, device, T_START, hooks or {})
    out = harness.driver(cell.traffic["kind"]).run(ctx)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": name,
           "count": cell.chips, "memory_peak_bytes": int(out["memory_peak_bytes"])}
    return out, result_line(cell, out, trace, dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import harness

    cell = harness.find_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: the cell needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    Context.log(f"card: {card_line()}")
    out, line = execute(cell, args.seed, args.seconds, bool(args.trace),
                        torch.device("cuda", 0))
    found = harness.banned_modules()
    if found:
        print(f"benchmark: JAX modules loaded in this process: {found}", file=sys.stderr)
        return 3
    for k, v in out["log"].items():
        Context.log(f"{k}: {v!r}")
    for name, c in line["checks"].items():
        Context.log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
