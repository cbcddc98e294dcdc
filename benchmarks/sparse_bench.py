#!/usr/bin/env python
"""Sparse-vector retrieval benchmark (reference: SindiIndex /
BlockMaxQuantizedIndexBenchmark).

Synthetic SPLADE-like corpus; measures quantized top-10 retrieval QPS and
recall vs exact float dot product.
Prints one JSON line; ``main(argv)`` also returns it (bench.py calls it
in-process).
Run: python benchmarks/sparse_bench.py [--docs 100000] [--cpu-rehearsal]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, ".")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--docs", type=int, default=50000)
    ap.add_argument("--vocab", type=int, default=30000)
    ap.add_argument("--nnz", type=int, default=120)
    ap.add_argument("--queries", type=int, default=256,
                    help="serving batch size (256: per-query weights make "
                    "every clause row unique, so the batch partitions into "
                    "~512-row compact groups whose cold bank builds "
                    "dominate warm-up — 256 queries halve that at equal "
                    "per-query throughput)")
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="allow a dry run on the CPU (its output names it)")
    args = ap.parse_args(argv)

    from diagon_tpu.bench.cache import bench_cache_dir, enable_compile_cache
    from diagon_tpu.bench.device import measured_device

    enable_compile_cache()
    device = measured_device(args.cpu_rehearsal)

    from diagon_tpu.sparse import SparseIndex, SparseSearcher, SparseVector

    rng = np.random.Generator(np.random.PCG64(5))
    # Zipfian term usage like learned-sparse models
    probs = 1.0 / np.arange(1, args.vocab + 1) ** 1.05
    probs /= probs.sum()

    import pickle

    cache_dir = bench_cache_dir()
    cache = os.path.join(
        cache_dir, f"sparse_{args.docs}_{args.vocab}_{args.nnz}.pkl"
    )
    t0 = time.time()
    if os.path.exists(cache):
        with open(cache, "rb") as f:
            idx = pickle.load(f)
        log(f"index: loaded cache {cache} ({time.time() - t0:.1f}s)")
    else:
        # vectorized Zipf sampling: one inverse-CDF draw for every slot
        # (a per-doc rng.choice(p=probs) is O(vocab) per call — minutes
        # at 50k docs on one host core)
        cdf = np.cumsum(probs)
        ids_all = np.searchsorted(
            cdf, rng.random((args.docs, args.nnz))
        ).astype(np.int64)
        keep_n = rng.integers(30, args.nnz, size=args.docs)
        vecs = []
        for i in range(args.docs):
            ids = np.unique(ids_all[i, : keep_n[i]])
            vals = rng.random(len(ids)).astype(np.float32) * 2 + 0.05
            vecs.append(SparseVector(ids, vals))
        log(f"corpus: {time.time() - t0:.1f}s {args.docs} docs")
        t0 = time.time()
        idx = SparseIndex.build(vecs)
        log(f"index build: {time.time() - t0:.1f}s "
            f"({args.docs / (time.time() - t0):.0f} docs/s)")
        os.makedirs(cache_dir, exist_ok=True)
        with open(cache + ".tmp", "wb") as f:
            pickle.dump(idx, f, protocol=4)
        os.replace(cache + ".tmp", cache)
    searcher = SparseSearcher(idx)

    qs = []
    for _ in range(args.queries):
        k = int(rng.integers(8, 24))
        ids = np.unique(rng.choice(args.vocab, size=k, p=probs))
        qs.append(SparseVector(ids, rng.random(len(ids)).astype(np.float32)))

    # serving throughput: chained dispatches, one scalar readback ending
    # the chain (the same device-time methodology as bench.py)
    t0 = time.time()
    res = searcher.search_batch(qs, 10)  # compile + warm
    log(f"warm-up batch (compile): {time.time() - t0:.1f}s")
    nb = 8
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        handles = [searcher.dispatch_batch(qs, 10) for _ in range(nb)]
        fused = handles[-1][2]
        np.asarray(fused[0, 0])
        times.append((time.perf_counter() - t0) / nb)
    qps = args.queries / min(times)
    log(f"quantized top-10 (batched, device): {qps:.0f} qps "
        f"(trials ms/batch: {[round(t * 1e3, 2) for t in times]})")

    # bit-exactness vs the quantized numpy oracle on a batch sample (the
    # pruned path's certificate escalates any unsafe query, so device
    # results must equal the oracle exactly)
    t0 = time.time()
    for qi in range(0, args.queries, max(1, args.queries // 8)):
        s_d, d_d, h_d = res[qi]
        s_o, d_o, h_o = searcher.search_oracle(qs[qi], 10)
        assert list(d_d) == list(d_o), f"parity FAIL q{qi}"
        assert h_d == h_o and all(
            np.float32(a) == np.float32(b) for a, b in zip(s_d, s_o)
        ), f"parity FAIL q{qi}"
    log(f"batch sample: bit-exact vs quantized oracle "
        f"({time.time() - t0:.1f}s)")

    # recall vs exact over the FULL corpus (search_exact is the
    # vectorized CSR oracle; a subsampled oracle understates recall
    # because the searcher ranks over all docs). Quantized recall reads
    # the warm-up batch results; the certified rerank runs as ONE batched
    # dispatch (search_rerank_batch) — per-query device calls would each
    # compile fresh singleton shapes.
    t0 = time.time()
    nrec = 8
    rerank = searcher.search_rerank_batch(qs[:nrec], 10, R=512)
    rec_q, rec_r = [], []
    for qi in range(nrec):
        es, ed, _ = searcher.search_exact(qs[qi], 10)
        exact_top = set(int(d) for d in ed)
        rec_q.append(
            len(exact_top & set(int(d) for d in res[qi][1][:10])) / 10.0
        )
        rec_r.append(
            len(exact_top & set(int(d) for d in rerank[qi][1])) / 10.0
        )
    log(f"recall@10 quantized: {np.mean(rec_q):.3f}  "
        f"reranked (certified): {np.mean(rec_r):.3f} "
        f"({time.time() - t0:.1f}s)")

    out = {"metric": "sparse_top10_qps", "value": round(qps, 1),
           "unit": "qps",
           "recall10": round(float(np.mean(rec_q)), 3),
           "recall10_rerank": round(float(np.mean(rec_r)), 3),
           "device": device}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
