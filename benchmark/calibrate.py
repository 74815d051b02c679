"""The readings that the limits of ``limits/<cell>.json`` are set from, on
the chip at the cell's own size, many seeds in one process:

    python3 benchmark/calibrate.py --workload <cell> --seeds a,b,... \
        [--control a,b,c] [--faults a,b,c] [--misroute a,b,c] [--f32 a,b] [--seconds 6]

- program: each of ``--seeds``, the program against the f32 reference (the
  lower readings);
- control: training: the reference computed in fp8 put in the program's
  place; serving: the program's own int8 path, w8a8 (``faults.w8a8``), and
  the reference in fp8 beside it (the upper readings);
- faults: training: the loss over half of each batch, the mean taken over
  it (the reference with the fault, in the program's place); serving: each
  batch's answers handed to the next row's request;
- misroute (MoE training): the program with a router that swaps its k-th
  choice for its (k+1)-th on 4% of the tokens (``faults.misrouted_topk``);
- f32 (training): the program run in float32 (its kernels' f32 paths), a
  witness of what the bf16 rounding alone adds to the program's readings.

A training cell's state left unchanged reads 1 on ``change_gap`` by its
definition and needs no run. Prints one JSON line a reading.
"""

from __future__ import annotations

import json
import statistics
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:] = [str(HERE.parent)] + [p for p in sys.path if Path(p or ".").resolve() != HERE]


def worst(prog: dict, ref: dict, key: str, k: int = 3) -> list:
    """The ``k`` units of the largest gap of ``key``, for the record."""
    from benchmark.checks import SETTLED

    med_g = statistics.median(ref["grad"].values())
    med = statistics.median(ref[key].values())
    gaps = [(abs(prog[key][u] - ref[key][u]) / max(ref[key][u], med), u)
            for u in ref[key] if ref["grad"][u] >= SETTLED * med_g]
    return sorted(gaps, reverse=True)[:k]


def train(cell, seeds, control, faults, misroute, f32, dev) -> None:
    from benchmark import checks, faults as F
    from benchmark.drivers import train as D

    cfg, tr = cell.config, cell.traffic
    cfg32 = {**cfg, "model": {**cfg["model"], "dtype": "float32"}}
    moe = bool(cfg["model"].get("moe"))
    for seed in sorted(set(seeds) | set(control) | set(faults) | set(misroute) | set(f32)):
        t = time.perf_counter()
        free_ref = None if moe else D.reference(cfg, tr, seed, dev)
        ref_s = time.perf_counter() - t
        sides = []
        for kind, on, make in (
                ("program", seeds, lambda: D.Program(cfg, tr, seed, dev, {}).readings),
                ("program_f32", f32, lambda: D.Program(cfg32, tr, seed, dev, {}).readings),
                ("misroute", misroute,
                 lambda: D.Program(cfg, tr, seed, dev, F.misrouted_topk()).readings),
                ("control", control, lambda: D.reference(cfg, tr, seed, dev, prec="fp8")),
                ("half_batch", faults,
                 lambda: D.reference(cfg, tr, seed, dev, rows=tr["batch"] // 2))):
            if seed in on:
                got = make()
                D.free(dev)
                # an MoE run is judged by the reference replaying its routes
                ref = D.reference(cfg, tr, seed, dev, routes=got["routes"]) if moe else free_ref
                sides.append((kind, got, ref))
        for kind, got, ref in sides:
            print(json.dumps({"seed": seed, "kind": kind,
                              **checks.train_readings(got, ref),
                              "worst_grad": worst(got, ref, "grad"),
                              "worst_change": worst(got, ref, "change"),
                              "losses": got["losses"], "reference_losses": ref["losses"],
                              "reference_s": ref_s}), flush=True)
        D.free(dev)


def serve(cell, seeds, control, faults, dev, seconds: float) -> None:
    import numpy as np

    from benchmark import checks, faults as F, inputs
    from benchmark import run as R
    from benchmark.drivers import serve as S

    def rotated(serve_fn):
        return lambda wave: np.roll(serve_fn(wave), 1, axis=0)

    keep = {}
    real = checks.serve_readings

    def spy(answers, clip_of, ref_probs):   # what the run compared, kept for the fp8 reading
        keep["r"] = real(answers, clip_of, ref_probs)
        keep["ref"], keep["clips"] = ref_probs, clip_of
        return keep["r"]

    checks.serve_readings = spy
    for seed in sorted(set(seeds) | set(control) | set(faults)):
        for kind, hooks, on in (("program", {}, seeds), ("control", F.w8a8(dev), control),
                                ("rotated_answers", {"serve": rotated}, faults)):
            if seed not in on:
                continue
            out, line = R.execute(cell, seed, seconds, False, dev, hooks)
            print(json.dumps({"seed": seed, "kind": kind, **keep["r"],
                              "failed": line["failed"], "attempted": line["attempted"],
                              "p95_ms": line["metrics"]["serve_p95_ms"]["value"]}),
                  flush=True)
            if kind == "control":   # the reference in fp8 in the program's place
                fp8 = S.reference_probs(cell.config, inputs.weights(cell.config["model"], seed,
                                                                    dev),
                                        _pool(cell, seed, dev), _n_pad(cell), prec="fp8")
                print(json.dumps({"seed": seed, "kind": "control_fp8",
                                  **real(fp8[keep["clips"]], keep["clips"], keep["ref"])}),
                      flush=True)


def _pool(cell, seed: int, dev):
    from benchmark import inputs

    m, tr = cell.config["model"], cell.traffic
    return inputs.clips(tr["pool_clips"], int(cell.config["clip_seconds"] * m["sample_rate"]),
                        m["sample_rate"], seed, dev)


def _n_pad(cell) -> int:
    from benchmark.flops import token_counts

    m = cell.config["model"]
    return token_counts(m, int(cell.config["clip_seconds"] * m["sample_rate"]))[1]


def main() -> None:
    import argparse

    import torch

    from benchmark import harness

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--misroute", default="")
    ap.add_argument("--f32", default="")
    ap.add_argument("--seconds", type=float, default=6.0)
    a = ap.parse_args()

    def ints(s):
        return [int(x) for x in s.split(",") if x]

    cell = harness.find_cell(a.workload)
    dev = torch.device("cuda", 0)
    if cell.traffic["kind"] == "train":
        train(cell, ints(a.seeds), ints(a.control), ints(a.faults), ints(a.misroute),
              ints(a.f32), dev)
    else:
        serve(cell, ints(a.seeds), ints(a.control), ints(a.faults), dev, a.seconds)


if __name__ == "__main__":
    main()
