"""The serving knee, once, by a sweep of fixed rates on the chip:

    python3 benchmark/sweep_serve.py --workload <cell> --rates 300,400,... \
        [--seconds 20] [--seed n]

For each rate, one run of the cell's driver with its traffic's rate set to
it: the latency's median and 95th percentile, the 95th percentile of each
third of the window (a backlog that grows shows as rising thirds), the
batch fill and the serve call's time. The knee is the highest rate whose
thirds do not rise; the cell's traffic file then holds 0.8 of it.
"""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:] = [str(HERE.parent)] + [p for p in sys.path if Path(p or ".").resolve() != HERE]


def main() -> None:
    import argparse

    import torch

    from benchmark import harness
    from benchmark import run as R

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=2**31 + 101)
    a = ap.parse_args()
    cell = harness.find_cell(a.workload)
    for rate in (float(r) for r in a.rates.split(",")):
        c = dataclasses.replace(cell, traffic={**cell.traffic, "rate_per_s": rate})
        out, line = R.execute(c, a.seed, a.seconds, False, torch.device("cuda", 0))
        print(json.dumps({"rate_per_s": rate, "p95_ms": out["metrics"]["serve_p95_ms"],
                          "failed": out["failed"], "correct": out["correct"], **out["log"]}),
              flush=True)


if __name__ == "__main__":
    main()
