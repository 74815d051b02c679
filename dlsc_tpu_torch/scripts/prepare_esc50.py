"""Prepare ESC-50: raw WAVs → per-fold mmap'd shards (``data/prepare.py``).

    python -m dlsc_tpu_torch.scripts.prepare_esc50 [--raw data/raw/ESC-50-master] \
        [--out data/processed/esc50] [--validate-hash]

The counterpart of ``scripts/prepare_esc50.py``, with its flags and output
(44.1 kHz mono peak-normalised clips, folds 0..4, ``dataset_stats.json``,
optional SHA-256), on the port's ``data/prepare.py``.
"""

from __future__ import annotations

import argparse

from dlsc_tpu_torch.data.prepare import prepare_esc50


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--raw", default="data/raw/ESC-50-master")
    p.add_argument("--out", default="data/processed/esc50")
    p.add_argument("--validate-hash", action="store_true")
    args = p.parse_args(argv)
    stats = prepare_esc50(args.raw, args.out, validate_hash=args.validate_hash)
    print(f"prepared {stats['total_clips']} clips "
          f"({stats['total_duration_s']:.0f}s) into {args.out}")
    print({k: v for k, v in stats["folds"].items()})
    return stats


if __name__ == "__main__":
    main()
