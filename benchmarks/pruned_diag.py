#!/usr/bin/env python
"""Pruned-path diagnostic: escalation / fallback rates per batch shape.

The reference ships profiling mains that expose its pruning machinery's
behavior (``ProfileWAND.cpp``, ``benchmarks/multiblock_regression_test.cpp``);
this is the same for the block-max pruned batch path
(``search/row_engine.py``): for each batch shape it reports the
MetricsRegistry pruning counters (pruned vs exhaustive dispatches,
certificate escalations, compact-bank fallbacks, vocabulary partitions,
tiles rescored) plus the derived escalation rate — the silent perf
cliffs, made visible per run. It counts; it does not time, so it runs
on any backend.

Run: python benchmarks/pruned_diag.py [--docs 1000000] [--batch 1024]
Prints ONE JSON line to stdout; per-shape detail goes to stderr.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))



def log(*a):
    print(*a, file=sys.stderr, flush=True)


def counter_delta(before, after):
    keys = set(before) | set(after)
    return {
        k: after.get(k, 0) - before.get(k, 0)
        for k in sorted(keys)
        if k.startswith("search.") and after.get(k, 0) != before.get(k, 0)
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--docs", type=int, default=1_000_000)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--mixed-pool", type=int, default=160)
    args = ap.parse_args()

    from diagon_tpu.bench.cache import enable_compile_cache

    enable_compile_cache()
    import bench

    seg, _ = bench.build_or_load_segment(args.docs, fresh_stats=False)
    from diagon_tpu.bench.queries import (
        REUTERS_QUERIES,
        frequent_terms,
        mixed_query_batch,
    )
    from diagon_tpu.observability.metrics import registry
    from diagon_tpu.search.searcher import IndexSearcher

    s = IndexSearcher([seg])
    Q = args.batch
    pool = frequent_terms(s, "body", args.mixed_pool)
    shapes = {
        "or20_homogeneous": [REUTERS_QUERIES["or20"]] * Q,
        "mixed_distinct": mixed_query_batch(pool, n=Q, seed=42),
        "and2_homogeneous": [REUTERS_QUERIES["and2:oil+price"]] * Q,
    }
    out = {"docs": seg.num_docs, "batch": Q}
    detail = {}
    for name, batch in shapes.items():
        before = registry.snapshot()
        t0 = time.time()
        h = s.dispatch_batch(batch, 10)
        s.collect_batch(h)
        dt = time.time() - t0
        d = counter_delta(before, registry.snapshot())
        pruned = d.get("search.pruned_dispatches", 0)
        exhaustive = d.get("search.exhaustive_dispatches", 0)
        esc = d.get("search.escalations", 0)
        rate = esc / Q
        detail[name] = dict(d)
        detail[name]["escalation_rate"] = round(rate, 4)
        log(
            f"{name}: {dt:.2f}s pruned={pruned} exhaustive={exhaustive} "
            f"escalations={esc} ({rate:.2%} of queries) "
            f"fallbacks={d.get('search.compact_fallbacks', 0)} "
            f"partitions={d.get('search.compact_partitions', 0)} "
            f"tiles={d.get('search.tiles_rescored', 0)}"
        )
    out["escalation_rate_mixed"] = detail["mixed_distinct"]["escalation_rate"]
    out["detail"] = detail
    print(json.dumps(out))


if __name__ == "__main__":
    main()
