"""Tests of the benchmark harness, on the CPU at tiny sizes (the cases
marked ``gpu`` decide inside the test whether a card is there):

    python -m pytest benchmark/tests -q
"""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


# workloads whose files are ready and which BENCHMARK.json does not run yet
READY = [{"name": "ast_moe.train_b256", "config": "ast_moe", "traffic": "train_b256", "chips": 1},
         {"name": "ast_base.serve_b16", "config": "ast_base", "traffic": "serve_b16", "chips": 1}]


def tiny_cell(name: str):
    """The cell ``name`` of BENCHMARK.json at a size a test run holds: its
    configuration's widths cut (2 blocks of 128, 2 heads of 64, 4 experts),
    0.5-s clips, small pools and batches, its own limits kept."""
    from benchmark import harness

    bench = harness.spec()
    bench["workloads"] = bench["workloads"] + READY
    cell = harness.find_cell(name, bench)
    cfg = copy.deepcopy(cell.config)
    cfg["model"].update(emb_dim=128, depth=2, num_heads=2)
    if cfg["model"].get("moe"):
        cfg["model"]["moe"]["n_experts"] = 4
    cfg["clip_seconds"] = 0.5
    tr = dict(cell.traffic)
    if tr["kind"] == "train":
        tr.update(batch=4, pool_clips=16, profiled_steps=1)
    else:
        tr.update(pool_clips=8, rate_per_s=20.0, profiled_seconds=0.5, warm_calls=1,
                  late_s=10.0)
    cell.config, cell.traffic = cfg, tr
    return cell


@pytest.fixture
def cpu():
    import torch

    torch.set_num_threads(min(4, torch.get_num_threads()))
    return torch.device("cpu")
