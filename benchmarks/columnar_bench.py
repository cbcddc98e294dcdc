#!/usr/bin/env python
"""ClickBench-style columnar benchmark (reference: clickbench_benchmark.cpp
+ benchmarks/columnar/ColumnarStore.h, results in
benchmark_results/clickbench_20260225_102132.md).

Synthetic hits-like table mirroring the reference's columnar queries
(Q9 RegionID range / Q10 ResolutionWidth >= / Q14 CounterID narrow range)
plus aggregation + group-by. Measures device time per query by chaining
dispatches that end in one readback, and reports the ratio vs the
reference's measured single-thread P50s at the same row count.

Prints one JSON line; ``main(argv)`` also returns it (bench.py calls it
in-process).

Run: python benchmarks/columnar_bench.py [--rows 1000000] [--cpu-rehearsal]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

sys.path.insert(0, ".")

# reference ColumnarStore single-thread P50s at 100K rows (
# clickbench_20260225_102132.md: Q9 150us, Q10 137us, Q14 ~0us pure
# minmax bulk count). Scaling is ~linear in scanned granules; ratios are
# reported at measured row count vs (ref_us * rows / 100k) — conservative
# for Q14 whose bulk-count path is O(G).
REF_P50_US_100K = {"q9_region_range": 150.0, "q10_width_ge": 137.0,
                   "q14_counter_narrow": 1.0}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def build_table(rows: int, seed: int = 11):
    from diagon_tpu.columnar import ColumnarTable, Float64Column, Int64Column

    rng = np.random.Generator(np.random.PCG64(seed))
    t = ColumnarTable()
    # event-time: sorted (the classic MergeTree ORDER BY) -> prunable
    t.add_column("event_ts", Int64Column(np.sort(rng.integers(0, 1 << 22, rows))))
    t.add_column("user_id", Int64Column(rng.integers(0, 100000, rows)), minmax=True)
    t.add_column("counter_id", Int64Column(np.sort(rng.integers(0, 1 << 17, rows))),
                 minmax=True)
    t.add_column("region", Int64Column(rng.integers(0, 4096, rows)), minmax=True)
    t.add_column("res_width", Int64Column(rng.choice(
        [1366, 1440, 1536, 1920, 2560, 3840], rows)), minmax=True)
    t.add_column("duration", Float64Column(rng.gamma(2.0, 150.0, rows)))
    return t


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--chain", type=int, default=32,
                    help="dispatches per timing chain")
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="allow a dry run on the CPU (its output names it)")
    args = ap.parse_args(argv)

    import os

    from diagon_tpu.bench.cache import bench_cache_dir, enable_compile_cache
    from diagon_tpu.bench.device import measured_device

    enable_compile_cache()
    device = measured_device(args.cpu_rehearsal)

    from diagon_tpu.columnar import DeviceTable, write_table
    from diagon_tpu.store import RAMDirectory

    log(f"device={device}")
    t0 = time.time()
    # table-build cache: the 1M-row build (rng + two sorts + granule
    # stats) costs tens of seconds of one host core and is fully
    # deterministic
    import pickle

    # v12: the key carries a schema/version token — bumping it on any
    # build_table or granule/index-format change invalidates stale tables
    # (ADVICE r4: the old s11 key silently reused tables across format
    # changes)
    from diagon_tpu.columnar.table import GRANULE_ROWS as _GR

    cache = os.path.join(
        bench_cache_dir(),
        f"columnar_table_{args.rows}_g{_GR}_v12.pkl",
    )
    fresh_build = not os.path.exists(cache)
    if not fresh_build:
        with open(cache, "rb") as f:
            table = pickle.load(f)
        log(f"build: loaded cache {cache} ({time.time() - t0:.1f}s) "
            f"rows={table.num_rows} granules={table.num_granules}")
    else:
        table = build_table(args.rows)
        os.makedirs(os.path.dirname(cache), exist_ok=True)
        with open(cache + ".tmp", "wb") as f:
            pickle.dump(table, f, protocol=4)
        os.replace(cache + ".tmp", cache)
        log(f"build: {time.time() - t0:.1f}s rows={table.num_rows} "
            f"granules={table.num_granules}")

    # compression / store round-trip: stderr evidence only (doesn't feed
    # the JSON), so pay the one-core zlib/LZ4 pass only on a fresh build
    if fresh_build:
        d = RAMDirectory()
        t0 = time.time()
        write_table(d, "hits", table)
        raw = sum(
            c.values.nbytes
            for c in table.columns.values()
            if hasattr(c, "values")
        )
        stored = d.file_length("hits.col")
        log(f"store: {time.time() - t0:.1f}s raw={raw/1e6:.1f}MB "
            f"compressed={stored/1e6:.1f}MB ratio={raw/stored:.1f}x")

    dt = DeviceTable(table)

    # the reference's columnar trio (Q9/Q10/Q14) + local additions
    queries = {
        "q9_region_range": dict(filter_col="region", lower=200, upper=300),
        "q10_width_ge": dict(filter_col="res_width", lower=1900),
        "q14_counter_narrow": dict(filter_col="counter_id", lower=0,
                                   upper=100),
        "narrow_ts_agg": dict(
            filter_col="event_ts", lower=1 << 20, upper=(1 << 20) + (1 << 16),
            agg_col="duration",
        ),
        "wide_ts_agg": dict(
            filter_col="event_ts", lower=0, upper=1 << 21, agg_col="duration"
        ),
        "point_user": dict(filter_col="user_id", lower=777, upper=777),
    }

    results = {}
    for name, kw in queries.items():
        got = dt.range_agg(**kw)  # compile + correctness readback
        # oracle check (exact int64 host scan)
        col = table.columns[kw["filter_col"]].values
        lo = kw.get("lower", None)
        hi = kw.get("upper", None)
        mask = np.ones(len(col), bool)
        if lo is not None:
            mask &= col >= lo
        if hi is not None:
            mask &= col <= hi
        assert got["count"] == int(mask.sum()), (
            name, got["count"], int(mask.sum())
        )
        if kw.get("agg_col") is None and got["count"]:
            assert got["min"] == float(col[mask].min()), name
            assert got["max"] == float(col[mask].max()), name
        # metadata-resolvable queries answer on HOST (the reference's
        # SKIP/BULK levels, ColumnarStore.h) — time the host call; the
        # rest chain device dispatches and block once
        host_path = got.get("host_fast_path", False)
        times = []
        if host_path:
            reps = 200
            for _ in range(args.iters):
                t0 = time.perf_counter()
                for _ in range(reps):
                    dt.range_agg(**kw)
                times.append((time.perf_counter() - t0) / reps)
        else:
            for _ in range(args.iters):
                t0 = time.perf_counter()
                for _ in range(args.chain):
                    fused = dt.dispatch_range_agg(**kw)
                # one scalar readback ends the whole chain
                np.asarray(fused[0])
                times.append((time.perf_counter() - t0) / args.chain)
        dev_us = float(min(times) * 1e6)
        entry = {
            "device_us": round(dev_us, 1),
            "path": "host_bulk" if host_path else "device",
            "count": got["count"],
            "granules_scanned": got["granules_scanned"],
            "granules_total": got["granules_total"],
        }
        ref100k = REF_P50_US_100K.get(name)
        if ref100k is not None:
            ref_us = ref100k * args.rows / 100_000
            entry["vs_reference"] = round(ref_us / dev_us, 2)
        results[name] = entry
        log(f"{name}: device={dev_us:.0f}us count={got['count']} "
            f"granules={got['granules_scanned']}/{got['granules_total']}"
            + (f" vs_ref={entry.get('vs_reference')}x"
               if "vs_reference" in entry else ""))
    # group-by
    g = dt.range_group_agg("event_ts", "region", 4096, lower=0,
                           upper=1 << 21, agg_col="duration")
    ts_col = table.columns["event_ts"].values
    m = (ts_col >= 0) & (ts_col <= (1 << 21))
    want = np.bincount(
        table.columns["region"].values[m], minlength=4096
    )
    assert np.array_equal(g["group_counts"].astype(np.int64), want)
    log(f"group_by region: count={g['count']} (counts exact)")

    ratios = [v["vs_reference"] for v in results.values()
              if "vs_reference" in v]
    out = {
        "metric": "columnar_q9_device_us",
        "value": results["q9_region_range"]["device_us"],
        "unit": "us",
        "vs_reference_geomean": round(float(np.exp(np.mean(np.log(ratios)))), 2)
        if ratios else None,
        "detail": {k: v for k, v in results.items()},
        "device": device,
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
