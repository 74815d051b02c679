"""Feature-cache CLI: stats / cleanup / optimize / benchmark
(reference: scripts/cache_manager.py:233-302).

    python -m dlsc_tpu_torch.scripts.cache_manager stats     [--cache-dir data/cache]
    python -m dlsc_tpu_torch.scripts.cache_manager cleanup   --max-age DAYS
    python -m dlsc_tpu_torch.scripts.cache_manager optimize  --max-size GB
    python -m dlsc_tpu_torch.scripts.cache_manager benchmark [--mode ast] [--n 32] [--device cpu]

The counterpart of ``scripts/cache_manager.py`` on the port's
``data/cache.py``. ``benchmark`` times the port's eval pipeline (for
``ast`` and ``cnn_esc50`` log-mel on kernel K1) on the GPU, or on the CPU
with ``--device cpu``, against cache hits of its features.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from dlsc_tpu_torch.data.cache import FeatureCache


def cmd_stats(args) -> None:
    cache = FeatureCache(args.cache_dir)
    print(json.dumps(cache.report(), indent=2))


def cmd_cleanup(args) -> None:
    cache = FeatureCache(args.cache_dir)
    removed = cache.cleanup_by_age(args.max_age)
    print(f"removed {removed} entries older than {args.max_age} days")


def cmd_optimize(args) -> None:
    cache = FeatureCache(args.cache_dir)
    removed = cache.enforce_size_limit(int(args.max_size * 1e9))
    print(f"evicted {removed} entries to fit {args.max_size} GB")


def cmd_benchmark(args) -> None:
    """Measure feature compute vs cache hit latency (reference :165-230)."""
    import torch

    from dlsc_tpu_torch.data.pipeline import DevicePipeline, PipelineConfig
    from dlsc_tpu_torch.train.loop import resolve_device

    device = resolve_device(args.device)
    cache = FeatureCache(args.cache_dir, config={"mode": args.mode})
    pipe = DevicePipeline(PipelineConfig(mode=args.mode, num_classes=50))
    rng = np.random.default_rng(0)
    wave = torch.from_numpy(rng.standard_normal((args.n, 220_500)).astype(np.float32) * 0.3)

    t0 = time.perf_counter()
    feats = pipe.eval_batch(wave.to(device)).cpu().numpy()
    compute_s = time.perf_counter() - t0

    for i in range(args.n):
        cache.put(f"bench_{i}", feats[i])
    t0 = time.perf_counter()
    for i in range(args.n):
        assert cache.get(f"bench_{i}") is not None
    hit_s = time.perf_counter() - t0

    print(json.dumps({
        "mode": args.mode,
        "device": str(device),
        "n_clips": args.n,
        "compute_clips_per_s": round(args.n / compute_s, 1),
        "cache_hit_clips_per_s": round(args.n / hit_s, 1),
        **cache.report(),
    }, indent=2))


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--cache-dir", default="data/cache")
    sub = p.add_subparsers(dest="cmd", required=True)
    # defaults mirror the reference CLI (scripts/cache_manager.py:269-287):
    # cleanup --max-age 30 days, optimize --max-size 5.0 GB, benchmark
    # --mode envnet_v2
    sub.add_parser("stats")
    c = sub.add_parser("cleanup"); c.add_argument("--max-age", type=float, default=30)
    o = sub.add_parser("optimize"); o.add_argument("--max-size", type=float, default=5.0)
    b = sub.add_parser("benchmark")
    b.add_argument("--mode", default="envnet_v2",
                   choices=["envnet_v2", "ast", "cnn_esc50"])
    b.add_argument("--n", type=int, default=32)
    b.add_argument("--device", default="auto", help="'auto' (the GPU) or 'cpu'")
    args = p.parse_args(argv)
    {"stats": cmd_stats, "cleanup": cmd_cleanup,
     "optimize": cmd_optimize, "benchmark": cmd_benchmark}[args.cmd](args)


if __name__ == "__main__":
    main()
