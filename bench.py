#!/usr/bin/env python
"""Headline benchmark: Reuters-class OR-20 query throughput on one GPU.

Prints ONE JSON line to stdout:
  {"metric": "reuters_or20_throughput", "value": <qps>, "unit": "qps",
   "vs_baseline": <qps / 6060.6>, ...scale/mixed fields...}

Baseline: the C++ reference's OR-20 P50 of 165 us/query on a 64-vCPU
c7i.16xlarge (BASELINE.md) = 6,060.6 QPS single-stream. Target >= 10x.

STRUCTURE (the round-2 lesson, VERDICT.md weak #1: the old bench ran a
710 s parity gate + unbounded component stages BEFORE printing its one
JSON line and got killed by the driver): every stage now runs under a
global --budget deadline, the stages that feed the JSON line run FIRST
(slim 3-query parity gate -> headline -> mixed batch -> scale tiers),
the JSON prints as soon as they finish, and everything else (full
parity, latency tables, component benches) runs after it, each capped.

Corpus: deterministic Reuters-shaped synthetic corpus (19,043 docs — the
real Reuters-21578 text is not redistributable here; see
diagon_tpu/bench/synthetic.py); if DIAGON_REUTERS_PATH points at the real
Reuters-21578 SGML distribution it is used instead (bench/reuters.py).
Queries: the reference benchmark's exact term lists
(reuters_benchmark.cpp:193-268) plus a 1024-distinct-query mixed batch
across the same families.

Everything except the JSON line goes to stderr. --quick runs a small
corpus for smoke testing. The bench measures the GPU and refuses any
other backend unless --cpu-rehearsal is given; the JSON line names the
device it ran on. Every stage, the scale tiers and the component benches
included, runs in this one process, so one process holds the card.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import sys
import time

import numpy as np

from diagon_tpu.bench.cache import bench_cache_dir, enable_compile_cache

CACHE_DIR = bench_cache_dir()
BASELINE_OR20_QPS = 1e6 / 165.0  # reference OR-20 P50 165us -> 6060.6 QPS
# reference phrase P50 62us (avg of 5, BASELINE.md:24) -> 16,129 QPS
BASELINE_PHRASE_QPS = 1e6 / 62.0

T0 = time.time()
DEADLINE = [T0 + 780.0]


def remaining() -> float:
    return DEADLINE[0] - time.time()


def log(*args):
    print(f"[{time.time() - T0:6.1f}s]", *args, file=sys.stderr, flush=True)


def measure_indexing(num_docs: int) -> dict:
    """Fresh ingest+flush measurement (docs materialized first, like the
    reference's dataset adapter reading pre-parsed files —
    reuters_benchmark.cpp times addDocument+flush, not file parsing)."""
    from diagon_tpu.bench.synthetic import corpus_documents
    from diagon_tpu.index.memory_index import MemoryIndex
    from diagon_tpu.index.segment import flush_memory_index

    t0 = time.time()
    docs = list(corpus_documents(num_docs=num_docs))
    t_gen = time.time() - t0
    # best of 3 trials (same discipline as the qps trials' min): host
    # noise only ever SUBTRACTS throughput
    best = None
    for _ in range(3):
        mem = MemoryIndex()
        t0 = time.time()
        # bulk API (reference IndexWriter::addDocuments): one native call
        # per (field, run) instead of a per-doc python loop
        mem.add_documents(docs)
        t_ingest = time.time() - t0
        t0 = time.time()
        seg = flush_memory_index(mem, "_bench")
        t_flush = time.time() - t0
        if best is None or t_ingest + t_flush < best[0] + best[1]:
            best = (t_ingest, t_flush, seg)
    t_ingest, t_flush, seg = best
    return {
        "corpus_gen_s": round(t_gen, 2),
        "ingest_s": round(t_ingest, 2),
        "flush_s": round(t_flush, 2),
        "docs_per_s": round(num_docs / (t_ingest + t_flush)),
        "_segment": seg,
    }


def build_or_load_segment(num_docs: int, fresh_stats: bool = True):
    os.makedirs(CACHE_DIR, exist_ok=True)
    bnd_dir = os.path.join(CACHE_DIR, f"segment_{num_docs}.bnd.d")
    cache = os.path.join(CACHE_DIR, f"segment_{num_docs}.pkl")
    if os.path.isdir(bnd_dir):
        # .bnd bundle cache: mmap'd array views (the engine's own on-disk
        # format) load a 10M-doc segment in seconds where unpickling the
        # 19 GB host object costs minutes of one-core CPU
        from diagon_tpu.store import FSDirectory
        from diagon_tpu.store.format import read_segment

        t0 = time.time()
        seg = read_segment(FSDirectory(bnd_dir), "_bench")
        try:
            with open(os.path.join(bnd_dir, "stats.json")) as f:
                build_stats = json.load(f)
        except Exception:
            build_stats = {}
        log(f"loaded .bnd segment {bnd_dir} ({time.time() - t0:.1f}s)")
        if fresh_stats:
            stats = measure_indexing(num_docs)
            stats.pop("_segment")
            return seg, stats
        return seg, build_stats
    if os.path.exists(cache):
        log(f"loading cached segment {cache}")
        with open(cache, "rb") as f:
            seg, build_stats = pickle.load(f)
        if fresh_stats:
            stats = measure_indexing(num_docs)
            stats.pop("_segment")
            return seg, stats
        return seg, build_stats

    log(f"building synthetic Reuters corpus ({num_docs} docs)...")
    stats = measure_indexing(num_docs)
    seg = stats.pop("_segment")
    with open(cache, "wb") as f:
        pickle.dump((seg, stats), f, protocol=4)
    return seg, stats


def index_bytes_per_doc(seg) -> dict:
    """Actual serialized index size (the .bnd on-disk format)."""
    from diagon_tpu.store import RAMDirectory, write_segment

    d = RAMDirectory()
    files = write_segment(d, seg)
    total = sum(d.file_length(f) for f in files)
    return {"total": total, "bytes_per_doc": round(total / seg.num_docs, 1)}


def assert_parity(searcher, oracle, query, k=10, name=""):
    want = oracle.search(query, k)
    got = searcher.search(query, k)
    assert got.doc_ids() == want.doc_ids(), (
        f"PARITY FAIL {name}: {got.doc_ids()} != {want.doc_ids()}"
    )
    assert got.total_hits == want.total_hits, name
    for o, d in zip(want.score_docs, got.score_docs):
        assert o.score == d.score, (name, o, d)


class OracleCache:
    """Disk cache of oracle results for the big scale tiers: the oracle
    is a single-threaded numpy scorer — a 10M-doc OR-20 oracle pass
    costs minutes, so its (deterministic) result is computed once and
    replayed. Keyed by a corpus fingerprint so a regenerated corpus
    invalidates it."""

    def __init__(self):
        self.path = os.path.join(CACHE_DIR, "oracle_cache.pkl")
        try:
            with open(self.path, "rb") as f:
                self.data = pickle.load(f)
        except Exception:
            self.data = {}

    @staticmethod
    def fingerprint(seg) -> tuple:
        fd = next(iter(seg.fields.values()))
        return (seg.num_docs, int(fd.postings.doc_freq.sum()))

    def want(self, oracle, seg, tag: str, q, k: int):
        # repr(q) is part of the key: a tag like "mixed[64]" names a batch
        # POSITION, and the query at that position changes whenever the
        # mixed pool/seed changes — replaying a stale cached oracle result
        # would fail parity on correct output (or worse, pass on wrong)
        key = (self.fingerprint(seg), tag, repr(q), k)
        hit = self.data.get(key)
        if hit is None:
            td = oracle.search(q, k)
            hit = (
                td.doc_ids(),
                [sd.score for sd in td.score_docs],
                td.total_hits,
            )
            self.data[key] = hit
            os.makedirs(CACHE_DIR, exist_ok=True)
            with open(self.path, "wb") as f:
                pickle.dump(self.data, f, protocol=4)
        return hit


ORACLE_CACHE = OracleCache()


def batch_parity(searcher, oracle, batch, results, sample_idx, k=10,
                 tag="", seg=None):
    """Bit-exact check of a SAMPLE of an executed batch vs the oracle
    (cached per corpus+query when ``seg`` is given)."""
    for qi in sample_idx:
        q, got = batch[qi], results[qi]
        if seg is not None:
            ids, scores, hits = ORACLE_CACHE.want(
                oracle, seg, f"{tag}[{qi}]", q, k
            )
        else:
            td = oracle.search(q, k)
            ids = td.doc_ids()
            scores = [sd.score for sd in td.score_docs]
            hits = td.total_hits
        assert got.doc_ids() == ids, (
            f"BATCH PARITY FAIL {tag}[{qi}] {q!r}: "
            f"{got.doc_ids()} != {ids}"
        )
        assert got.total_hits == hits, (tag, qi)
        for o, d in zip(scores, got.score_docs):
            assert o == d.score, (tag, qi, o, d)


def device_throughput(searcher, batch, k=10, n_batches=64, trials=6):
    """Device qps for a dispatched batch: n_batches back-to-back
    dispatches, one tiny scalar readback ending the chain."""
    h = searcher.dispatch_batch(batch, k)
    res = searcher.collect_batch(h)  # warm/compile + sanity
    assert res[0].total_hits >= 0

    def trial() -> float:
        t0 = time.perf_counter()
        handles = [
            searcher.dispatch_batch(batch, k) for _ in range(n_batches)
        ]
        _, _, parts = handles[-1]
        np.asarray(parts[-1][2][0, 0])
        return (time.perf_counter() - t0) / n_batches

    ts = [trial() for _ in range(trials)]
    per_batch = float(min(ts))  # host stalls only ever add time
    return len(batch) / per_batch, ts, res


def main():
    """Budget-guaranteed wrapper: the measurement runs in a daemon worker
    thread and THIS thread prints the one JSON line no matter what. A
    device stall blocks inside an XLA call where no deadline check (and
    no signal handler) can run, so the main thread never enters device
    code."""
    import threading

    args = _parse_args()
    holder = {}

    def target():
        try:
            _run(args, holder)
        except BaseException as exc:  # noqa: BLE001 — any worker death
            holder["died"] = f"{type(exc).__name__}: {exc}"
            import traceback

            traceback.print_exc(file=sys.stderr)

    worker = threading.Thread(target=target, daemon=True)
    worker.start()
    stop_at = T0 + max(30.0, args.budget - 10.0)
    while worker.is_alive() and time.time() < stop_at:
        worker.join(timeout=1.0)
    if not holder.get("printed"):
        result = holder.get("result") or {
            "metric": "reuters_or20_throughput",
            "value": 0,
            "unit": "qps",
            "vs_baseline": 0,
        }
        result.setdefault(
            "error",
            holder.get("died")
            or f"budget exceeded at stage {holder.get('stage', 'startup')!r}"
            " (device stall?)",
        )
        print(json.dumps(result), flush=True)
        log(f"EMERGENCY JSON emitted (stage {holder.get('stage')!r}, "
            f"died={holder.get('died')!r})")
        os._exit(0 if result.get("value") else 2)
    worker.join()


def _parse_args():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="2k-doc smoke run")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--latency-reps", type=int, default=10)
    ap.add_argument("--skip-parity", action="store_true")
    ap.add_argument("--mixed-pool", type=int, default=160)
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="allow a dry run on the CPU (its output names it)")
    ap.add_argument(
        "--budget",
        type=float,
        default=float(os.environ.get("BENCH_BUDGET_S", 860)),
        help="global wall-clock budget (s); the JSON line always prints "
        "before this elapses",
    )
    args = ap.parse_args()
    DEADLINE[0] = T0 + args.budget
    return args


def _run(args, holder):
    holder["stage"] = "jax init"
    from diagon_tpu.bench.device import measured_device

    enable_compile_cache()
    device = measured_device(args.cpu_rehearsal)
    log(f"device: {device}")

    from diagon_tpu.bench.queries import (
        REFERENCE_REUTERS_HITS,
        REUTERS_QUERIES,
        frequent_terms,
        mixed_query_batch,
    )
    from diagon_tpu.bench.reuters import load_real_reuters_segment
    from diagon_tpu.search.oracle import OracleSearcher
    from diagon_tpu.search.searcher import IndexSearcher

    real = load_real_reuters_segment()
    if real is not None:
        seg, build_stats = real
        corpus_kind = "real Reuters-21578"
    else:
        num_docs = 2000 if args.quick else 19043
        seg, build_stats = build_or_load_segment(num_docs)
        corpus_kind = "synthetic Reuters-shaped"
    log(f"segment: {seg.num_docs} docs ({corpus_kind}); build {build_stats}")
    size_stats = index_bytes_per_doc(seg)
    log(f"index size: {size_stats}")

    t0 = time.time()
    holder["stage"] = "device load"
    # query_cache=False: measured qps must re-score every iteration,
    # like the reference's benchmark loop (ReutersWANDBenchmark.cpp:195)
    searcher = IndexSearcher([seg], query_cache=False)
    oracle = OracleSearcher([seg])
    log(f"device load: {time.time() - t0:.2f}s")

    # ---- headline: OR-20 batched device throughput ----
    # The parity gate rides on the headline stages' OWN collected
    # results (batch_parity below), so it compiles no extra programs.
    # Phrase + the full 14-query sweep still run post-JSON in extras; a
    # parity failure still kills the worker BEFORE the JSON prints, so
    # the numbers stay gated. Batches chain on device with one scalar
    # readback; the end-to-end number (readbacks included) is logged
    # post-JSON.
    or20 = REUTERS_QUERIES["or20"]
    Q = min(args.batch, 64) if args.quick else args.batch
    nb, tr = (4, 2) if args.quick else (64, 6)
    holder["stage"] = "or20 headline"
    or20_batch = [or20] * Q
    qps, ts, or20_res = device_throughput(
        searcher, or20_batch, n_batches=nb, trials=tr
    )
    if not args.skip_parity:
        batch_parity(searcher, oracle, or20_batch, or20_res, [0],
                     tag="or20", seg=seg)
    log(
        f"or20 device throughput: Q={Q} qps={qps:,.0f} "
        f"(query 0 bit-exact; trials ms/batch: "
        f"{[round(t * 1e3, 2) for t in ts]})"
    )

    holder["result"] = {
        "metric": "reuters_or20_throughput",
        "value": round(qps, 1),
        "unit": "qps",
        "vs_baseline": round(qps / BASELINE_OR20_QPS, 2),
        "device": device,
    }

    # ---- mixed batch: 1024 DISTINCT queries across the reference's
    # term/OR/AND/boolean families (round-2 weak #2: the flagship number
    # assumed batch homogeneity) ----
    holder["stage"] = "mixed batch"
    pool = frequent_terms(searcher, "body", args.mixed_pool)
    # phrase_share=5: ~5% of the 19k serving batch is 2-3 term phrases
    # (VERDICT r4 missing #3 — phrase was never measured batched; scale
    # tiers keep share 0 so their recorded history stays comparable)
    mixed = mixed_query_batch(pool, n=Q, seed=42, phrase_share=5)
    mixed_qps, ts, mres = device_throughput(
        searcher, mixed, n_batches=nb // 2 or 1, trials=tr
    )
    sample = list(range(0, Q, max(1, Q // 24)))
    if not args.skip_parity:
        batch_parity(searcher, oracle, mixed, mres, sample, tag="mixedp",
                     seg=seg)
    log(
        f"mixed-1024 device throughput (incl. phrases): qps={mixed_qps:,.0f} "
        f"({len(sample)} sampled queries bit-exact; trials ms/batch: "
        f"{[round(t * 1e3, 2) for t in ts]})"
    )

    result = {
        "metric": "reuters_or20_throughput",
        "value": round(qps, 1),
        "unit": "qps",
        "vs_baseline": round(qps / BASELINE_OR20_QPS, 2),
        "mixed_qps": round(mixed_qps, 1),
        "mixed_vs_baseline": round(mixed_qps / BASELINE_OR20_QPS, 2),
        "device": device,
    }
    holder["result"] = dict(result)

    # ---- phrase batch: 1024 DISTINCT 2-3 term phrases (the reference's
    # headline phrase family, README.md:32 P50 62us -> 16.1k qps on 64
    # vCPUs; here measured as batched device throughput, bit-exact) ----
    holder["stage"] = "phrase batch"
    try:
        from diagon_tpu.bench.queries import phrase_query_batch

        phrases = phrase_query_batch(pool, n=Q, seed=43)
        phrase_qps, pts, pres = device_throughput(
            searcher, phrases, n_batches=nb // 2 or 1, trials=tr
        )
        psample = list(range(0, Q, max(1, Q // 12)))
        if not args.skip_parity:
            batch_parity(searcher, oracle, phrases, pres, psample,
                         tag="phraseb", seg=seg)
        log(
            f"phrase-1024 device throughput: qps={phrase_qps:,.0f} "
            f"({len(psample)} sampled queries bit-exact; trials ms/batch: "
            f"{[round(t * 1e3, 2) for t in pts]})"
        )
        result["phrase_qps"] = round(phrase_qps, 1)
        result["phrase_vs_baseline"] = round(
            phrase_qps / BASELINE_PHRASE_QPS, 2
        )
    except Exception as exc:
        import traceback

        traceback.print_exc(file=sys.stderr)
        result["phrase_error"] = f"{type(exc).__name__}: {exc}"[:120]
    holder["result"] = dict(result)
    holder["stage"] = "scale tiers"

    # ---- scale tiers, in this process (one process holds the card).
    # Component benches run before the 10M tier, which is the budget
    # hog; holder["result"] is refreshed after every stage so a budget
    # overrun still emits everything measured so far. ----
    import subprocess

    scale_records = {}

    def run_tier(docs, min_need):
        from benchmarks import scale_bench

        from diagon_tpu.bench.cache import find_cached

        cached = bool(
            find_cached(f"segment_{docs}.bnd.d")
            or find_cached(f"segment_{docs}.pkl")
        )
        tag = f"{docs // 1_000_000}m"
        if args.quick:
            return
        if remaining() < min_need:
            log(f"skipping {docs}-doc tier (remaining {remaining():.0f}s"
                f" < {min_need}s)")
            scale_records[f"or20_{tag}_error"] = (
                f"skipped: {remaining():.0f}s left < {min_need}s"
            )
            return
        if not cached:
            # build the tier's segment in-run when the budget allows, in
            # a host-only child process that never opens the card;
            # otherwise the JSON carries an explicit error key
            build_est = 170 if docs <= 1_000_000 else 3700
            if remaining() < min_need + build_est:
                log(f"{docs}-doc tier: no cached segment and building "
                    f"needs ~{build_est}s (remaining {remaining():.0f}s)")
                scale_records[f"or20_{tag}_error"] = (
                    f"no cached segment (build ~{build_est}s > "
                    f"{remaining():.0f}s left — scripts/build_scale.py)"
                )
                return
            log(f"building {docs}-doc segment in-run (~{build_est}s)...")
            t0 = time.time()
            try:
                bp = subprocess.run(
                    [sys.executable, "scripts/build_scale.py",
                     "--docs", str(docs)],
                    capture_output=True, text=True,
                    timeout=remaining() - min_need,
                    env=dict(os.environ, JAX_PLATFORMS="cpu"),
                )
                sys.stderr.write((bp.stdout or "")[-1500:])
                if bp.returncode != 0:
                    sys.stderr.write((bp.stderr or "")[-1500:])
                    scale_records[f"or20_{tag}_error"] = (
                        f"in-run build failed rc={bp.returncode}"
                    )
                    return
                log(f"built {docs}-doc segment ({time.time() - t0:.0f}s)")
            except subprocess.TimeoutExpired:
                scale_records[f"or20_{tag}_error"] = (
                    f"in-run build timeout after {time.time() - t0:.0f}s"
                )
                return
        try:
            t0 = time.time()
            tier = scale_bench.run(scale_bench.parse_args(
                ["--docs", str(docs), "--batch", str(Q)]
            ))
            for key in ("or20_qps", "or20_vs_baseline", "mixed_qps",
                        "mixed_vs_baseline"):
                if key in tier:
                    scale_records[key.replace("_", f"_{tag}_", 1)] = tier[key]
            if "mixed_qps" not in tier:
                scale_records[f"mixed_{tag}_error"] = tier.get(
                    "mixed_error", "mixed phase missing"
                )[:120]
            log(f"scale {tag} ({time.time() - t0:.0f}s): "
                f"or20 {tier.get('or20_qps', 0):,} qps = "
                f"{tier.get('or20_vs_baseline')}x; mixed "
                f"{tier.get('mixed_qps', 0):,} qps = "
                f"{tier.get('mixed_vs_baseline')}x ({tier.get('parity')})")
        except Exception as exc:  # a failed tier must not eat the JSON
            log(f"scale tier {tag} FAILED: {exc!r:.300}")
            scale_records[f"or20_{tag}_error"] = str(exc)[:120]

    holder["stage"] = "component benches"
    if not args.quick:
        component_benches(result)
        holder["result"] = dict(result)

    holder["stage"] = "10m tier"
    run_tier(10_000_000, 200)
    result.update(scale_records)
    holder["result"] = dict(result)

    run_tier(1_000_000, 100)
    result.update(scale_records)
    holder["result"] = dict(result)

    # ======== THE one JSON line (everything below is best-effort) ========
    holder["result"] = dict(result)
    print(json.dumps(result), flush=True)
    holder["printed"] = True
    log(f"headline JSON emitted at {time.time() - T0:.1f}s")

    extras = {}
    holder["stage"] = "extras"
    try:
        run_extras(args, searcher, oracle, extras)
    except Exception:
        import traceback

        traceback.print_exc(file=sys.stderr)

    from diagon_tpu.observability.metrics import registry

    prune_counters = {
        k: v for k, v in registry.snapshot().items()
        if k.startswith("search.")
    }
    log(f"pruning counters: {json.dumps(prune_counters)}")

    # ---- perf-trend gate (the reference's check_fst_regression.py role,
    # run automatically after every bench): append to the history and
    # flag any tracked metric >20% below its recorded best ----
    if device["platform"] != "gpu":
        return  # a CPU rehearsal never enters the GPU history
    try:
        import subprocess

        merged = dict(result)
        if isinstance(build_stats, dict) and "docs_per_s" in build_stats:
            merged["docs_per_s"] = build_stats["docs_per_s"]
        gate = subprocess.run(
            [sys.executable, "scripts/perf_trend.py", "record",
             json.dumps(merged)],
            capture_output=True, text=True, timeout=60,
        )
        tailtxt = ((gate.stdout or "") + (gate.stderr or ""))[-800:]
        log(f"perf-trend gate rc={gate.returncode}: {tailtxt.strip()}")
    except Exception as exc:  # pragma: no cover
        log(f"perf-trend gate failed to run: {exc}")


def component_benches(result):
    """Columnar + sparse component benches, in this process (their
    progress goes to stderr); flat keys land in the headline result."""
    import contextlib

    from benchmarks import columnar_bench, sparse_bench

    for name, fn, argv, keys in (
        ("columnar", columnar_bench.main, ["--rows", "1000000"],
         (("columnar_q9_us", "value"),
          ("columnar_vs_ref_geomean", "vs_reference_geomean"))),
        ("sparse", sparse_bench.main, ["--docs", "50000"],
         (("sparse_qps", "value"), ("sparse_recall10", "recall10"),
          ("sparse_recall10_rerank", "recall10_rerank"))),
    ):
        try:
            with contextlib.redirect_stdout(sys.stderr):
                comp = fn(argv + ["--cpu-rehearsal"])
            for flat, src in keys:
                if src in comp:
                    result[flat] = comp[src]
            log(f"component bench {name}: {comp}")
        except Exception as exc:  # a failed component must not eat the JSON
            result[f"{name}_error"] = str(exc)[:120]
            log(f"component bench {name} FAILED: {exc!r:.200}")


def run_extras(args, searcher, oracle, extras):
    """Post-JSON stages: full parity sweep, latency table, density table,
    component benches. Each checks the remaining budget first."""
    from diagon_tpu.bench.queries import (
        REFERENCE_REUTERS_HITS,
        REUTERS_QUERIES,
    )

    if not args.skip_parity and remaining() > 60:
        t0 = time.time()
        done = 0
        for name, q in REUTERS_QUERIES.items():
            if remaining() < 30:
                break
            assert_parity(searcher, oracle, q, name=name)
            done += 1
        log(f"full parity: {done}/{len(REUTERS_QUERIES)} queries bit-exact "
            f"({time.time() - t0:.1f}s)")
        extras["parity_full"] = done

    # corpus honesty: synthetic vs REAL-Reuters term/phrase density
    if remaining() > 45:
        cmp_rows = {}
        for name, ref_hits in REFERENCE_REUTERS_HITS.items():
            q = REUTERS_QUERIES.get(name)
            if q is not None:
                cmp_rows[name] = {
                    "ours": searcher.count(q),
                    "real_reuters_ref": ref_hits,
                }
        log("corpus density vs real Reuters (hits/query): "
            + json.dumps(cmp_rows))

    # single-stream latency (device batch throughput is the headline;
    # logged for completeness)
    if remaining() > 90:
        lat = {}
        for name, q in REUTERS_QUERIES.items():
            if remaining() < 45:
                break
            searcher.search(q, 10)
            times = []
            for _ in range(args.latency_reps):
                t0 = time.perf_counter()
                searcher.search(q, 10)
                times.append(time.perf_counter() - t0)
            lat[name] = round(float(np.percentile(times, 50) * 1e6), 1)
        log("single-stream P50 latency (us): " + json.dumps(lat))
        extras["latency_p50_us"] = lat

    # cold-batch dispatch cost: a NEW batch object of distinct queries
    # (plan build + bank reuse + any residual compiles) — the serving
    # cost the steady-state trials hide by reusing one batch
    if remaining() > 30 and not args.quick:
        from diagon_tpu.bench.queries import (
            frequent_terms as _ft,
            mixed_query_batch as _mqb,
        )

        pool = _ft(searcher, "body", args.mixed_pool)
        fresh = _mqb(pool, n=args.batch, seed=7)
        t0 = time.perf_counter()
        h = searcher.dispatch_batch(fresh, 10)
        searcher.collect_batch(h)
        extras["new_batch_dispatch_s"] = round(time.perf_counter() - t0, 3)
        log(f"new-batch dispatch+collect (plan build, cold): "
            f"{extras['new_batch_dispatch_s']}s")

    # end-to-end throughput incl. readbacks
    if remaining() > 45 and not args.quick:
        Q = args.batch
        or20 = REUTERS_QUERIES["or20"]
        batch = [or20] * Q
        t0 = time.perf_counter()
        PIPE = 8
        handles = [searcher.dispatch_batch(batch, 10) for _ in range(PIPE)]
        results = searcher.collect_many(handles)
        e2e = (time.perf_counter() - t0) / PIPE
        assert results[0][0].total_hits > 0
        extras["or20_e2e_qps"] = round(Q / e2e)
        log(f"or20 end-to-end (incl. readback): {Q / e2e:,.0f} qps")

    # component benches run in _run BEFORE the 10M tier (budget priority);
    # their numbers land in the headline result, not extras


if __name__ == "__main__":
    main()
