#!/usr/bin/env python
"""Smoke run of the search path on one NVIDIA GPU.

    python chip_smoke.py            # one card: every phase below
    python chip_smoke.py --multi    # four cards: the sharded phase only

It fails (non-zero exit, no result line) unless JAX's first device is a
GPU, and any failed check ends the run. Phases:

1. device: the card's name and power limit from ``nvidia-smi``, printed
   beside every time that follows;
2. the ``gpu``-marked tests, in a child process that ends before this
   process touches the card;
3. the pruned-path kernels at the 19k, 1M and 10M-doc widths (Q=1024):
   phase 1 (OR, bool2, bool) as the Pallas kernel and as plain XLA,
   against an f32 reference; phase 2 against numpy's sequential adds;
   ``memory_analysis()`` of each program and kernel-vs-XLA times;
4. a 1M-doc Reuters-shaped index: bulk-built, committed through
   ``IndexWriter``, reopened with ``DirectoryReader`` onto the card and
   served the OR-20, mixed and phrase batches of 1024 queries, all
   checked bit for bit against ``OracleSearcher`` (which runs in worker
   processes on the host while the card works);
5. sparse top-10 through the same pruned kernels, and a 1M-row columnar
   range aggregate, against their exact references.

``--multi`` runs ``ShardedSearcher`` over four 250k-doc segments on a
1-D mesh of four cards (pruned and exhaustive programs) against the
oracle and the same segments in one ``IndexSearcher`` on one card.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import tempfile
import time
import xml.etree.ElementTree as ET

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
Q = 1024
K = 10
# (padded doc count, compact-bank rows) of the 19k, 1M and 10M tiers;
# the 10M tier's mixed pool is 32 terms, so its banks stay at 64 rows
TIERS = ((19_456, 256), (1_000_448, 256), (10_000_384, 64))
ORACLE_WORKERS = 12
CARD = "card unknown"


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    """``name, power.limit`` of the first card, from a child process."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    if not out:
        raise RuntimeError("nvidia-smi lists no card")
    return out[0].strip()


def run_gpu_tests():
    """The gpu-marked tests in a child process: they must all run (none
    skipped) and pass."""
    with tempfile.TemporaryDirectory() as tmp:
        xml = os.path.join(tmp, "gpu.xml")
        t0 = time.time()
        rc = subprocess.run(
            [sys.executable, "-m", "pytest", "tests", "-m", "gpu", "-q",
             "-p", "no:cacheprovider", "-p", "no:randomly",
             f"--junitxml={xml}"],
            cwd=ROOT, env=dict(os.environ, DIAGON_TEST_DEVICE="gpu"),
            timeout=600,
        ).returncode
        suite = ET.parse(xml).getroot()
        suite = suite if suite.tag == "testsuite" else suite[0]
        n = {k: int(suite.get(k, 0))
             for k in ("tests", "failures", "errors", "skipped")}
    log(f"gpu tests: {n} rc={rc} ({time.time() - t0:.1f}s) [{CARD}]")
    if rc != 0 or n["tests"] == 0 or n["skipped"] or n["failures"] \
            or n["errors"]:
        raise SystemExit("gpu-marked tests failed or did not run")


def median_time(fn, *args, n=7):
    """Median wall time of ``fn(*args)`` after one warm-up call, each
    call ending in ``block_until_ready``."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts), ts


def memory_line(jitted, *args) -> str:
    m = jitted.lower(*args).compile().memory_analysis()
    if m is None:
        return "memory_analysis: n/a"
    return (f"memory_analysis: args {m.argument_size_in_bytes} B, "
            f"out {m.output_size_in_bytes} B, "
            f"temp {m.temp_size_in_bytes} B")


# ---------------------------------------------------------------------------
# phase 3: kernels at real widths
# ---------------------------------------------------------------------------


def _largest_divisor(n: int, cap: int) -> int:
    return max(d for d in range(1, cap + 1) if n % d == 0)


def phase1_reference(bank, live, a_sc, rq, sh, ng, params, mode):
    """Exact-arithmetic phase 1 from the f32 bank: per (query, tile) the
    f32 score maximum over the tile (-1 where no doc is feasible) and
    the exact per-query match counts. f32 products at HIGHEST precision;
    counts are sums of 0/1 values, exact in f32."""
    import jax
    import jax.numpy as jnp

    U8, D = bank.shape
    G = D // 128
    ct = _largest_divisor(G, 128)
    w = ct * 128
    hp = jax.lax.Precision.HIGHEST

    def dot(a, b):
        return jax.lax.dot_general(
            a, b, (((0,), (0,)), ((), ())), precision=hp,
            preferred_element_type=jnp.float32,
        )

    @jax.jit
    def run(bank, live, a_sc, rq, sh, ng, params):
        def chunk(i):
            b = jax.lax.dynamic_slice_in_dim(bank, i * w, w, 1)
            lv = jax.lax.dynamic_slice_in_dim(live, i * w, w) > 0
            s = dot(a_sc, b).reshape(-1, ct, 128)
            lv = lv.reshape(1, ct, 128)
            if mode == "or":
                m = (s > 0) & lv
            else:
                p = (b > 0).astype(jnp.float32)
                rc, oc, nc = (dot(r, p).reshape(-1, ct, 128)
                              for r in (rq, sh, ng))
                m = ((rc == params[0][:, None, None])
                     & (oc >= params[1][:, None, None]) & (nc == 0)
                     & ((rc + oc) > 0) & lv)
            cnt = m.sum(axis=2)
            tmax = s.max(axis=2)
            if mode != "or":
                tmax = jnp.where(cnt > 0, tmax, -1.0)
            return tmax, cnt.sum(axis=1)

        t, h = jax.lax.map(chunk, jnp.arange(G // ct))
        return t.transpose(1, 0, 2).reshape(-1, G), h.sum(axis=0)

    return run(bank, live, a_sc, rq, sh, ng, params)


def phase1_inputs(key, D, U8, mode):
    import jax
    import jax.numpy as jnp

    ks = jax.random.split(key, 8)
    u = lambda k, shape: jax.random.uniform(k, shape, jnp.float32)  # noqa
    bank = jnp.where(u(ks[0], (U8, D)) < 0.3, u(ks[1], (U8, D)) * 9.0, 0.0)
    bank = bank.at[0].set(0.0)  # the zero row
    live = (u(ks[2], (D,)) < 0.97).astype(jnp.float32)

    def ind(k, p):
        return (u(k, (U8, Q)) < p).astype(jnp.float32).at[0].set(0.0)

    a_sc = ind(ks[3], 20.0 / U8)
    rq, sh, ng = ind(ks[4], 1.5 / U8), ind(ks[5], 4.0 / U8), ind(ks[6], 0.5 / U8)
    if mode == "bool2":
        sh = jnp.where(rq > 0, 0.0, sh)  # one role per (row, query)
        ng = jnp.zeros_like(ng)
    if mode == "or":
        rq = sh = ng = jnp.zeros_like(rq)
    params = jnp.zeros((8, Q), jnp.float32)
    params = params.at[0].set(rq.sum(axis=0))
    params = params.at[1].set(jnp.minimum(1.0, sh.sum(axis=0)))
    bf = lambda a: a.astype(jnp.bfloat16)  # noqa: E731
    roles = {
        "or": (),
        "bool2": (bf(rq * 256.0 + sh),),
        "bool": (bf(rq), bf(sh), bf(ng)),
    }[mode]
    return bank, live, a_sc, rq, sh, ng, params, (
        bf(bank), live, bf(a_sc), roles, params,
    )


def check_phase1(D, U8, mode, key, results):
    import jax

    from diagon_tpu.ops.approx import approx_select_xla
    from diagon_tpu.ops.pallas.approx_pass import approx_select_triton

    bank, live, a_sc, rq, sh, ng, params, args = phase1_inputs(
        key, D, U8, mode
    )
    xla = jax.jit(approx_select_xla)
    tx, hx = xla(*args)
    tk, hk = approx_select_triton(*args)
    te, he = phase1_reference(bank, live, a_sc, rq, sh, ng, params, mode)
    tx, hx, tk, hk, te, he = map(np.asarray, (tx, hx, tk, hk, te, he))
    del bank
    # counts are sums of 0/1 values: the kernel's equal the reference's
    # exactly, and so do its -1 markers of tiles with no feasible doc
    bad = np.flatnonzero(hk != he)
    assert bad.size == 0, ("phase-1 kernel hit counts differ", mode, D,
                           bad.size, bad[:4], hk[bad[:4]], he[bad[:4]])
    assert np.array_equal(tk < 0, te < 0), ("tile markers differ", mode, D)
    feas = te >= 0
    # soundness of the selection bound (row_engine._APPROX_RELEPS = 2^-7)
    bound = tk * np.float32(1.0 + 2.0 ** -7)
    assert (te[feas] <= bound[feas]).all(), ("bound violated", mode, D)
    # the plain XLA form is the timing baseline here; its agreement is
    # reported, not required (the GPU runs the kernel)
    xla_bad = int((hx != he).sum())
    both = feas & (tx >= 0)
    # kernel vs plain XLA: identical bf16 products summed in another
    # f32 order, within 2^-8 relative where both call a tile feasible
    rel = np.abs(tk - tx)[both] / np.maximum(tx[both], 1e-30)
    if not xla_bad:
        assert (rel <= 2.0 ** -8).all(), ("kernel vs xla", mode, D, rel.max())
    t_k, _ = median_time(approx_select_triton, *args)
    t_x, _ = median_time(xla, *args)
    log(f"phase1 {mode:5s} D={D} U8={U8} Q={Q}: hits exact, bound holds, "
        f"max rel kernel/xla {rel.max() if rel.size else 0:.3g}, "
        f"xla queries with other hit counts {xla_bad}; "
        f"kernel {t_k * 1e3:.3f} ms, xla {t_x * 1e3:.3f} ms "
        f"(median of 7) [{CARD}]")
    log(f"  kernel {memory_line(approx_select_triton, *args)}")
    log(f"  xla    {memory_line(xla, *args)}")
    results.append({"phase": 1, "mode": mode, "D": D, "U8": U8, "Q": Q,
                    "kernel_ms": t_k * 1e3, "xla_ms": t_x * 1e3,
                    "xla_count_mismatches": xla_bad})


def check_phase2(D, U8, boolean, key, results):
    import jax
    import jax.numpy as jnp

    from diagon_tpu.search.row_engine import PRUNE_B0, rescore_compact

    G = D // 128
    B = min(G, max(PRUNE_B0, -(-K // 128) + 1, G // 512))
    Tq = 8 if boolean else 20
    ks = jax.random.split(key, 4)
    bank = jax.random.uniform(ks[0], (G, U8, 128), jnp.float32) * 7.0
    bank = jnp.where(bank < 3.0, 0.0, bank).at[:, 0].set(0.0)
    cidx = jax.random.randint(ks[1], (Q, Tq), 0, U8, jnp.int32)
    tsel = jnp.sort(jax.random.randint(ks[2], (Q, B), 0, G, jnp.int32), 1)
    flags = (jax.random.randint(ks[3], (Q, Tq), 0, 16, jnp.int32)
             if boolean else None)
    args = (bank, cidx, tsel) + ((flags,) if boolean else ())
    fn = jax.jit(rescore_compact)
    got = fn(*args)
    got = [np.asarray(g) for g in (got if boolean else (got,))]
    bh, ch, th = np.asarray(bank), np.asarray(cidx), np.asarray(tsel)
    fh = np.asarray(flags) if boolean else np.ones((Q, Tq), np.int32)
    want = [np.zeros((Q, B, 128), np.float32) for _ in got]
    for t in range(Tq):
        rows = bh[th, ch[:, t][:, None]]  # [Q, B, 128]
        pres = (rows > 0).astype(np.float32)
        for bit, w in enumerate(want):
            on = ((fh[:, t] >> bit) & 1).astype(bool)[:, None, None]
            w += np.where(on, rows if bit == 0 else pres, np.float32(0))
    del bh
    for g, w in zip(got, want):
        assert np.array_equal(g, w), ("phase-2 rescore differs", D, boolean)
    t2, _ = median_time(fn, *args)
    kind = "bool" if boolean else "or"
    log(f"phase2 {kind:5s} D={D} U8={U8} Q={Q} B={B} Tq={Tq}: bit-exact; "
        f"{t2 * 1e3:.3f} ms (median of 7) [{CARD}]")
    log(f"  {memory_line(fn, *args)}")
    results.append({"phase": 2, "mode": kind, "D": D, "U8": U8, "Q": Q,
                    "B": B, "Tq": Tq, "xla_ms": t2 * 1e3})


# ---------------------------------------------------------------------------
# oracle workers (host processes that never touch the card)
# ---------------------------------------------------------------------------

_ORACLE = None


def _oracle_init(index_dir):
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, ROOT)
    global _ORACLE
    from diagon_tpu.index.reader import DirectoryReader
    from diagon_tpu.search.oracle import OracleSearcher
    from diagon_tpu.store import FSDirectory

    reader = DirectoryReader.open(FSDirectory(index_dir))
    _ORACLE = OracleSearcher(reader.segments_data())


def _oracle_job(q):
    td = _ORACLE.search(q, K)
    return td.doc_ids(), [sd.score for sd in td.score_docs], td.total_hits


def start_oracle(index_dir, queries):
    pool = multiprocessing.get_context("spawn").Pool(
        ORACLE_WORKERS, _oracle_init, (index_dir,)
    )
    return pool, pool.map_async(_oracle_job, queries, chunksize=1)


def assert_equal(tag, got, want):
    ids, scores, hits = want
    assert got.doc_ids() == ids, (tag, got.doc_ids(), ids)
    assert got.total_hits == hits, (tag, got.total_hits, hits)
    assert [sd.score for sd in got.score_docs] == scores, tag


def family(q) -> str:
    from diagon_tpu.search.query import BooleanQuery

    if not isinstance(q, BooleanQuery):
        return type(q).__name__
    occ = sorted({c.occur.name for c in q.clauses})
    return f"bool{len(q.clauses)}:{'+'.join(occ)}"


def sample_by_family(batch, n, seed):
    """>= ``n`` seeded batch positions with every query family in it."""
    rng = np.random.Generator(np.random.PCG64(seed))
    fams = {}
    for i, q in enumerate(batch):
        fams.setdefault(family(q), []).append(i)
    per = max(1, -(-n // len(fams)))
    out = set()
    for idx in fams.values():
        out.update(rng.choice(idx, min(per, len(idx)), replace=False).tolist())
    rest = [i for i in range(len(batch)) if i not in out]
    if len(out) < n:
        out.update(rng.choice(rest, n - len(out), replace=False).tolist())
    return sorted(out), sorted(fams)


def counters() -> dict:
    from diagon_tpu.observability.metrics import registry

    snap = registry.snapshot()
    names = ("pruned_dispatches", "escalations", "exhaustive_dispatches",
             "compact_fallbacks", "sharded_escalations")
    return {n: snap.get(f"search.{n}", 0) for n in names}


# ---------------------------------------------------------------------------
# phase 4: search at a deployment size
# ---------------------------------------------------------------------------


def search_phase(tmp, docs=1_000_000):
    import jax

    from diagon_tpu.bench.bulk_build import build_synthetic_segment
    from diagon_tpu.bench.queries import (
        REUTERS_QUERIES,
        frequent_terms,
        mixed_query_batch,
        phrase_query_batch,
    )
    from diagon_tpu.index.reader import DirectoryReader
    from diagon_tpu.index.writer import IndexWriter, IndexWriterConfig
    from diagon_tpu.search.searcher import IndexSearcher
    from diagon_tpu.store import FSDirectory

    t0 = time.time()
    seg = build_synthetic_segment(num_docs=docs)
    t_build = time.time() - t0
    t0 = time.time()
    index_dir = os.path.join(tmp, "reuters")
    with IndexWriter(FSDirectory(index_dir),
                     IndexWriterConfig(merge_scheduler="serial")) as w:
        w.add_segment(seg)
        w.commit()
    t_write = time.time() - t0
    log(f"{docs}-doc index: bulk build {t_build:.1f}s, commit {t_write:.1f}s "
        "(host)")

    pool_terms = frequent_terms([seg], "body", 160)
    del seg
    batches = {
        "or20": [REUTERS_QUERIES["or20"]] * Q,
        "mixed": mixed_query_batch(pool_terms, n=Q, seed=42, phrase_share=5),
        "phrase": phrase_query_batch(pool_terms, n=Q, seed=43),
    }
    checks = [("reuters:" + n, q, None) for n, q in REUTERS_QUERIES.items()]
    checks.append(("or20[0]", batches["or20"][0], ("or20", 0)))
    mixed_idx, fams = sample_by_family(batches["mixed"], 64, seed=1)
    checks += [(f"mixed[{i}]", batches["mixed"][i], ("mixed", i))
               for i in mixed_idx]
    checks += [(f"phrase[{i}]", batches["phrase"][i], ("phrase", i))
               for i in range(0, Q, 64)]
    log(f"oracle: {len(checks)} queries on {ORACLE_WORKERS} host workers; "
        f"mixed sample covers {fams}")
    pool, pending = start_oracle(index_dir, [q for _, q, _ in checks])
    try:
        t0 = time.time()
        reader = DirectoryReader.open(FSDirectory(index_dir))
        searcher = IndexSearcher(reader, query_cache=False)
        log(f"reopen + upload: {time.time() - t0:.1f}s [{CARD}]")
        results = {}
        for name, batch in batches.items():
            c0 = counters()
            t0 = time.perf_counter()
            res = searcher.collect_many([searcher.dispatch_batch(batch, K)])
            t_first = time.perf_counter() - t0
            t0 = time.perf_counter()
            res = searcher.collect_many(
                [searcher.dispatch_batch(batch, K) for _ in range(2)]
            )[-1]
            t_warm = (time.perf_counter() - t0) / 2
            c1 = counters()
            delta = {k: c1[k] - c0[k] for k in c1}
            results[name] = res
            log(f"batch {name}: first (compile+run) {t_first:.2f}s, warm "
                f"{t_warm * 1e3:.1f} ms/batch of {Q}; counters {delta} "
                f"[{CARD}]")
        reuters = {n: searcher.search(q, K) for n, q in REUTERS_QUERIES.items()}
        wants = pending.get(timeout=900)
    finally:
        pool.close()
        pool.join()
    for (tag, _q, where), want in zip(checks, wants):
        got = reuters[tag[8:]] if where is None else \
            results[where[0]][where[1]]
        assert_equal(tag, got, want)
    c = counters()
    assert c["compact_fallbacks"] == 0, c
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    log(f"{docs}-doc search: {len(checks)} queries bit-exact vs OracleSearcher "
        f"(14 Reuters + batch samples); counters {c}; peak_bytes_in_use "
        f"{peak} [{CARD}]")
    phase1_end_to_end(searcher, batches, results)


def phase1_end_to_end(searcher, batches, results):
    """Warm batch times with phase 1 as the Pallas kernel and as plain
    XLA, in turns (kernel, xla, kernel), with the host otherwise idle;
    each result is checked against the first run's."""
    import jax

    from diagon_tpu.ops import approx

    times = {}
    for turn, use_kernel in enumerate((True, False, True)):
        approx.GPU_KERNEL = use_kernel
        jax.clear_caches()
        for name in ("or20", "mixed"):
            batch = batches[name]
            res = searcher.collect_many([searcher.dispatch_batch(batch, K)])
            ts = []
            for _ in range(5):
                t0 = time.perf_counter()
                res = searcher.collect_many(
                    [searcher.dispatch_batch(batch, K)])
                ts.append(time.perf_counter() - t0)
            for got, want in zip(res[0], results[name]):
                assert got.doc_ids() == want.doc_ids(), (name, use_kernel)
                assert got.total_hits == want.total_hits, (name, use_kernel)
            key = f"{name} {'kernel' if use_kernel else 'xla'}"
            times.setdefault(key, []).append(statistics.median(ts) * 1e3)
    approx.GPU_KERNEL = True
    log(f"phase 1 end to end, warm dispatch+collect of {Q} queries, median "
        "of 5 per turn (turns kernel, xla, kernel): "
        + "; ".join(f"{k} {[round(t, 2) for t in v]} ms"
                    for k, v in times.items()) + f" [{CARD}]")


# ---------------------------------------------------------------------------
# phase 5: sparse and columnar
# ---------------------------------------------------------------------------


def sparse_phase(docs=50_000):
    from diagon_tpu.sparse import SparseIndex, SparseSearcher, SparseVector

    vocab, nnz, nq = 30_000, 120, 256
    rng = np.random.Generator(np.random.PCG64(5))
    probs = 1.0 / np.arange(1, vocab + 1) ** 1.05
    probs /= probs.sum()
    ids_all = np.searchsorted(np.cumsum(probs), rng.random((docs, nnz)))
    keep = rng.integers(30, nnz, size=docs)
    vecs = []
    for i in range(docs):
        ids = np.unique(ids_all[i, : keep[i]])
        vecs.append(SparseVector(
            ids, rng.random(len(ids)).astype(np.float32) * 2 + 0.05))
    searcher = SparseSearcher(SparseIndex.build(vecs))
    qs = []
    for _ in range(nq):
        ids = np.unique(rng.choice(vocab, size=int(rng.integers(8, 24)),
                                   p=probs))
        qs.append(SparseVector(ids, rng.random(len(ids)).astype(np.float32)))
    c0 = counters()
    t0 = time.perf_counter()
    res = searcher.search_batch(qs, K)
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = searcher.search_batch(qs, K)
    t_warm = time.perf_counter() - t0
    c1 = counters()
    assert c1["pruned_dispatches"] > c0["pruned_dispatches"], c1
    for qi in range(0, nq, 8):
        s_d, d_d, h_d = res[qi]
        s_o, d_o, h_o = searcher.search_oracle(qs[qi], K)
        assert list(d_d) == list(d_o) and h_d == h_o, qi
        assert [np.float32(x) for x in s_d] == [np.float32(x) for x in s_o]
    log(f"sparse top-10 ({docs} docs, {nq} queries): {nq // 8} sampled "
        f"queries bit-exact vs the quantized oracle; first batch "
        f"{t_first:.2f}s, warm {t_warm * 1e3:.1f} ms [{CARD}]")


def columnar_phase(rows=1_000_000):
    from diagon_tpu.columnar import ColumnarTable, DeviceTable, Int64Column

    rng = np.random.Generator(np.random.PCG64(11))
    ts = np.sort(rng.integers(0, 1 << 22, rows))
    width = rng.choice([1366, 1440, 1536, 1920, 2560, 3840], rows)
    t = ColumnarTable()
    t.add_column("event_ts", Int64Column(ts))
    t.add_column("res_width", Int64Column(width), minmax=True)
    dt = DeviceTable(t)
    lo, hi = 1 << 20, (1 << 21) + 12345
    t0 = time.perf_counter()
    got = dt.range_agg("event_ts", lo, hi, agg_col="res_width",
                       host_fast=False)
    t_first = time.perf_counter() - t0
    m = (ts >= lo) & (ts <= hi)
    want = (int(m.sum()), int(width[m].min()), int(width[m].max()))
    assert (got["count"], int(got["min"]), int(got["max"])) == want, (
        got, want)
    # the engine adds its exact int32 per-granule sums in f32: within
    # 2^-16 relative over a few hundred granules
    wsum = int(width[m].sum())
    assert abs(got["sum"] - wsum) <= wsum * 2.0 ** -16, (got["sum"], wsum)
    log(f"columnar range aggregate ({rows} rows, device path): "
        f"count/min/max exact vs numpy {want}, sum {got['sum']:.0f} vs "
        f"{wsum}; first call {t_first:.2f}s [{CARD}]")


# ---------------------------------------------------------------------------
# --multi: the document-partitioned path on four cards
# ---------------------------------------------------------------------------


def multi_phase(tmp, per=250_000):
    import jax

    from diagon_tpu.bench.bulk_build import build_synthetic_segment
    from diagon_tpu.bench.queries import (
        REUTERS_QUERIES,
        frequent_terms,
        mixed_query_batch,
    )
    from diagon_tpu.index.reader import DirectoryReader
    from diagon_tpu.index.writer import IndexWriter, IndexWriterConfig
    from diagon_tpu.parallel.sharded import ShardedSearcher
    from diagon_tpu.search.searcher import IndexSearcher
    from diagon_tpu.store import FSDirectory

    S = 4
    assert len(jax.devices()) >= S, f"--multi needs {S} cards"
    t0 = time.time()
    index_dir = os.path.join(tmp, "reuters_4x250k")
    with IndexWriter(FSDirectory(index_dir),
                     IndexWriterConfig(merge_scheduler="serial")) as w:
        for s in range(S):
            w.add_segment(build_synthetic_segment(num_docs=per, seed=1000 + s))
        w.commit()
    shards = DirectoryReader.open(FSDirectory(index_dir)).segments_data()
    log(f"4 x {per}-doc segments: built and committed in {time.time() - t0:.1f}s")
    pool_terms = frequent_terms(shards, "body", 160)
    batch = mixed_query_batch(pool_terms, n=64, seed=42)
    reuters = list(REUTERS_QUERIES.items())
    oracle_qs = [q for _, q in reuters] + batch
    pool, pending = start_oracle(index_dir, oracle_qs)
    try:
        t0 = time.time()
        sharded = ShardedSearcher(shards, "body")
        devs = {d for d in sharded.heavy_banks.sharding.device_set}
        assert len(devs) == S, f"shards on {len(devs)} devices"
        log(f"ShardedSearcher on {sorted(str(d) for d in devs)}: "
            f"{time.time() - t0:.1f}s [{CARD}]")
        one = IndexSearcher(shards, query_cache=False)
        c0 = counters()
        t0 = time.perf_counter()
        pruned = sharded.search_batch(batch, K)
        t_p = time.perf_counter() - t0
        sharded.approx_min_q = 1 << 30  # the exhaustive program
        sharded._plan_cache.clear()
        t0 = time.perf_counter()
        exhaustive = sharded.search_batch(batch, K)
        t_e = time.perf_counter() - t0
        solo = [sharded.search(q, K) for _, q in reuters]
        single = one.search_batch(batch, K)
        single_r = [one.search(q, K) for _, q in reuters]
        wants = pending.get(timeout=900)
    finally:
        pool.close()
        pool.join()
    for i, want in enumerate(wants[: len(reuters)]):
        assert_equal(f"sharded {reuters[i][0]}", solo[i], want)
        assert_equal(f"1-card {reuters[i][0]}", single_r[i], want)
    for i, want in enumerate(wants[len(reuters):]):
        assert_equal(f"sharded pruned [{i}]", pruned[i], want)
        assert_equal(f"sharded exhaustive [{i}]", exhaustive[i], want)
        assert_equal(f"1-card [{i}]", single[i], want)
    log(f"sharded 4 x {per} docs: 14 Reuters + 64 mixed queries bit-exact "
        f"vs OracleSearcher and the 1-card IndexSearcher; pruned batch "
        f"{t_p:.2f}s, exhaustive batch {t_e:.2f}s (first calls, compile "
        f"included); counters {counters()} (before {c0}) [{CARD}]")


def main():
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the sharded phase on four cards")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import diagon_tpu  # noqa: F401 — fails outside a checkout

    CARD = card_line()
    log(f"card: {CARD}")
    if not args.multi:
        run_gpu_tests()

    import jax

    from diagon_tpu.bench.cache import enable_compile_cache

    log(f"compile cache: {enable_compile_cache()}")
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX found {devs[0].platform}")
    log(f"jax {jax.__version__}: {len(devs)} x {devs[0].device_kind}")
    t_all = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        if args.multi:
            multi_phase(tmp)
        else:
            results = []
            key = jax.random.PRNGKey(0)
            for D, U8 in TIERS:
                for mode in ("or", "bool2", "bool"):
                    key, sub = jax.random.split(key)
                    check_phase1(D, U8, mode, sub, results)
                for boolean in (False, True):
                    key, sub = jax.random.split(key)
                    check_phase2(D, U8, boolean, sub, results)
            log("kernel times: " + json.dumps(results))
            search_phase(tmp)
            sparse_phase()
            columnar_phase()
    log(f"all phases passed in {time.time() - t_all:.1f}s [{CARD}]")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }}), flush=True)


if __name__ == "__main__":
    main()
