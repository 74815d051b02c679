"""Prepare UrbanSound8K: raw WAVs → 10 per-fold shards (pad/trim to 4 s).

    python -m dlsc_tpu_torch.scripts.prepare_urbansound8k [--raw data/raw/UrbanSound8K] \
        [--out data/processed/urbansound8k]

The counterpart of ``scripts/prepare_urbansound8k.py``, on the port's
``data/prepare.py``.
"""

from __future__ import annotations

import argparse

from dlsc_tpu_torch.data.prepare import prepare_us8k


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--raw", default="data/raw/UrbanSound8K")
    p.add_argument("--out", default="data/processed/urbansound8k")
    args = p.parse_args(argv)
    stats = prepare_us8k(args.raw, args.out)
    print(f"prepared {stats['total_clips']} clips into {args.out}")
    return stats


if __name__ == "__main__":
    main()
