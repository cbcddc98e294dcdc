#!/usr/bin/env python
"""Scale benchmark: OR-20 + mixed-batch throughput at 1M/10M docs.

``run(parse_args([...]))`` measures one tier in the calling process
(bench.py runs its tiers that way); standalone use keeps knobs for batch
size / tile budget experiments and prints one JSON line:
  {"or20_qps": N, "or20_vs_baseline": N, "mixed_qps": N,
   "mixed_vs_baseline": N, "parity": "bit-exact", "device": {...}}
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BASELINE_OR20_QPS = 1e6 / 165.0


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _mem_gb(jax) -> str:
    try:
        st = jax.local_devices()[0].memory_stats()
        return (f"{st['bytes_in_use'] / 2**30:.2f} GiB in use / "
                f"{st.get('bytes_limit', 0) / 2**30:.2f} limit")
    except Exception:
        return "n/a"


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--docs", type=int, default=1_000_000)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--trial-batches", type=int, default=32)
    ap.add_argument("--b0", type=int, default=0, help="override prune_B0")
    ap.add_argument("--skip-parity", action="store_true")
    ap.add_argument("--skip-mixed", action="store_true")
    ap.add_argument("--mixed-pool", type=int, default=0,
                    help="term pool for the mixed batch (0 = auto: 160, "
                    "shrunk at 10M docs where the pool's banks must fit "
                    "HBM; the reference's own query tables are a few "
                    "dozen fixed terms, reuters_benchmark.cpp:193-268)")
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="allow a dry run on the CPU (its output names it)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from diagon_tpu.bench.cache import enable_compile_cache
    from diagon_tpu.bench.device import measured_device

    enable_compile_cache()
    device = measured_device(args.cpu_rehearsal)
    out = run(args)
    out["device"] = device
    print(json.dumps(out))


def run(args) -> dict:
    """Measure one tier; returns its result dict."""
    import jax

    import bench

    seg, _ = bench.build_or_load_segment(args.docs, fresh_stats=False)
    log(f"segment: {seg.num_docs} docs")

    from diagon_tpu.bench.queries import (
        REUTERS_QUERIES,
        frequent_terms,
        mixed_query_batch,
    )
    from diagon_tpu.search.oracle import OracleSearcher
    from diagon_tpu.search.searcher import IndexSearcher

    t0 = time.time()
    # query_cache=False: measured qps re-scores every dispatch (the
    # reference's bench loop re-runs full WAND scoring per iteration)
    s = IndexSearcher([seg], query_cache=False)
    oracle = OracleSearcher([seg])
    or20 = REUTERS_QUERIES["or20"]
    Q = args.batch
    b = [or20] * Q
    if args.b0:
        ctx = s._ctx("body")
        for ex in ctx.row_executors:
            if ex is not None:
                ex.prune_B0 = args.b0
    h = s.dispatch_batch(b, 10)
    res = s.collect_batch(h)
    log(f"setup (load+compile): {time.time() - t0:.1f}s; mem {_mem_gb(jax)}")

    out = {"docs": seg.num_docs, "batch": Q}
    if not args.skip_parity:
        t0 = time.time()
        bench.batch_parity(s, oracle, b, res, [0], tag="or20", seg=seg)
        log(f"parity: or20 bit-exact ({time.time() - t0:.1f}s)")
        out["parity"] = "bit-exact"

    def trial(batch, n):
        t0 = time.perf_counter()
        hs = [s.dispatch_batch(batch, 10) for _ in range(n)]
        _, _, parts = hs[-1]
        np.asarray(parts[-1][2][0, 0])
        return (time.perf_counter() - t0) / n

    ts = [trial(b, args.trial_batches) for _ in range(args.iters)]
    qps = Q / min(ts)
    log(f"or20 trials ms/batch: {[round(t * 1e3, 2) for t in ts]}")
    out["or20_qps"] = round(qps)
    out["or20_vs_baseline"] = round(qps / BASELINE_OR20_QPS, 2)

    if not args.skip_mixed:
        # the batch's vocabulary banks (~10 B/doc/row) must fit the
        # executors' 16 GB-era cache budgets next to the index; at 10M
        # docs that holds the index plus ONE modest compact bank, so the
        # mixed pool shrinks until one bank
        # covers the whole batch (partitioned groups would thrash the LRU
        # — every dispatch rebuilds every group's banks) and an OOM
        # retries with a smaller pool instead of failing the phase
        import gc

        huge = seg.num_docs >= 4 << 20
        pools = (
            [args.mixed_pool] if args.mixed_pool
            else ([32] if huge else [160])
        )
        for pool_n in pools:
            try:
                ctx = s._ctx("body")
                for ex in ctx.row_executors:
                    if ex is not None:
                        ex._batch_cache.clear()
                        ex._batch_bytes = 0
                        if huge:
                            # one group must admit the whole mixed vocab:
                            # pool + light/phrase rows + zero row
                            ex.COMPACT_GROUP_BYTES = 7 << 30
                            # on-demand entries use ON_DEMAND_CACHE_BUDGET
                            # (7 GB default); keep the legacy attr for the
                            # non-on-demand path at 4-10M doc sizes
                            ex.BATCH_CACHE_BUDGET = 7 << 30
                gc.collect()
                log(f"mem before mixed: {_mem_gb(jax)}")
                pool = frequent_terms(s, "body", pool_n)
                mixed = mixed_query_batch(pool, n=Q, seed=42)
                hm = s.dispatch_batch(mixed, 10)
                mres = s.collect_batch(hm)
                if not args.skip_parity:
                    bench.batch_parity(
                        s, oracle, mixed, mres,
                        list(range(0, Q, max(1, Q // 8))), tag="mixed",
                        seg=seg,
                    )
                    log("parity: mixed sample bit-exact")
                ts = [
                    trial(mixed, max(8, args.trial_batches // 2))
                    for _ in range(max(3, args.iters - 1))
                ]
                mqps = Q / min(ts)
                log(f"mixed trials ms/batch (pool {pool_n}): "
                    f"{[round(t * 1e3, 2) for t in ts]}")
                out["mixed_qps"] = round(mqps)
                out["mixed_vs_baseline"] = round(mqps / BASELINE_OR20_QPS, 2)
                out["mixed_pool"] = pool_n
                break
            except Exception as exc:  # the or20 result must still print
                log(f"mixed phase (pool {pool_n}) FAILED: {exc!r:.300}")
                out["mixed_error"] = str(exc)[:120]
                out.pop("mixed_qps", None)

    from diagon_tpu.observability.metrics import registry

    counters = {
        k: v for k, v in registry.snapshot().items()
        if k.startswith("search.")
    }
    log(f"pruning counters: {json.dumps(counters)}")
    return out


if __name__ == "__main__":
    main()
