"""Print the host's and the GPUs' specs (the port's counterpart of
``scripts/check_specs.py``).

    python -m dlsc_tpu_torch.scripts.check_specs

Host facts (OS, Python, CPUs, RAM), then torch and CUDA (versions, each
visible device's name, memory and SM count), then the cards' name and power
limit as ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
prints them (a card set below its maximum power runs slower under load:
keep that line beside every time taken on it), then the scheduler's
environment.
"""

from __future__ import annotations

import os
import platform
import subprocess


def nvidia_smi() -> list[str]:
    """The cards' ``name, power.limit`` lines; empty without nvidia-smi."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return []
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def main(argv: list[str] | None = None) -> None:
    print("== host ==")
    print(f"  os:      {platform.platform()}")
    print(f"  python:  {platform.python_version()}")
    print(f"  cpus:    {os.cpu_count()}")
    try:
        with open("/proc/meminfo") as f:
            total_kb = int(next(line for line in f if line.startswith("MemTotal")).split()[1])
        print(f"  ram:     {total_kb / 1e6:.1f} GB")
    except (OSError, StopIteration, ValueError):
        pass

    print("== torch ==")
    import torch

    print(f"  version: {torch.__version__}")
    print(f"  cuda:    {torch.version.cuda if torch.cuda.is_available() else 'not available'}")
    for i in range(torch.cuda.device_count()):
        p = torch.cuda.get_device_properties(i)
        print(f"  device:  cuda:{i} {p.name} ({p.total_memory / 2**30:.1f} GiB, "
              f"{p.multi_processor_count} SMs, sm_{p.major}{p.minor})")
    print(f"  device_count: {torch.cuda.device_count()}")

    print("== nvidia-smi (name, power.limit) ==")
    lines = nvidia_smi()
    for line in lines:
        print(f"  {line}")
    if not lines:
        print("  nvidia-smi not found")

    print("== scheduler env ==")
    for var in ("SLURM_JOB_ID", "SLURM_JOB_NODELIST", "CUDA_VISIBLE_DEVICES"):
        if os.environ.get(var):
            print(f"  {var}={os.environ[var]}")


if __name__ == "__main__":
    main()
