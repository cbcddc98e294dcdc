#!/usr/bin/env python
"""Cost of Q-bucket padding on the 10M-doc or20 batch.

A homogeneous [or20]*1024 batch dedups to ONE unique plan, which the
executor pads to the Q=8 bucket — 8x the phase-1 product columns and 8x
the phase-2 tile rescores. This script times the or20 batch with the
stock bucketing and with an identity bucket (Q=1) on the same segment
and code, isolating the padding cost.

Usage: python scripts/profile_or20_scale.py [--docs 10000000]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--docs", type=int, default=10_000_000)
    ap.add_argument("--batch", type=int, default=1024)

    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="allow a dry run on the CPU (its output names it)")
    args = ap.parse_args()

    from diagon_tpu.bench.cache import enable_compile_cache
    from diagon_tpu.bench.device import measured_device

    enable_compile_cache()
    log(f"device={measured_device(args.cpu_rehearsal)}")

    import bench
    from diagon_tpu.bench.queries import REUTERS_QUERIES
    from diagon_tpu.search import row_engine
    from diagon_tpu.search.searcher import IndexSearcher

    seg, _ = bench.build_or_load_segment(args.docs, fresh_stats=False)
    s = IndexSearcher([seg])
    or20 = REUTERS_QUERIES["or20"]
    b = [or20] * args.batch

    def measure(tag):
        t0 = time.time()
        h = s.dispatch_batch(b, 10)
        s.collect_batch(h)
        log(f"{tag}: warm dispatch+collect {time.time() - t0:.1f}s")
        ts = []
        for _ in range(4):
            t0 = time.perf_counter()
            hs = [s.dispatch_batch(b, 10) for _ in range(32)]
            _, _, parts = hs[-1]
            np.asarray(parts[-1][2][0, 0])
            ts.append((time.perf_counter() - t0) / 32)
        ms = min(ts) * 1e3
        log(f"{tag}: {[round(t * 1e3, 2) for t in ts]} ms/batch "
            f"-> {args.batch / min(ts):,.0f} qps")
        return ms

    measure("stock Q buckets (Q=8 pad)")

    # no Q padding for the deduped batch
    stock = row_engine.RowExecutor._bucket_q
    row_engine.RowExecutor._bucket_q = staticmethod(lambda q: q)
    try:
        ctx = s._ctx("body")
        for ex in ctx.row_executors:
            if ex is not None:
                ex._batch_cache.clear()
                ex._batch_bytes = 0
                ex._dedup_cache.clear()
        s._query_cache.clear()
        measure("identity buckets (Q=1)")
    finally:
        row_engine.RowExecutor._bucket_q = stock

    from diagon_tpu.observability.metrics import registry

    snap = {k: v for k, v in registry.snapshot().items()
            if k.startswith("search.")}
    log(f"pruning counters: {snap}")


if __name__ == "__main__":
    main()
