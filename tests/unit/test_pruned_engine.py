"""Block-max pruned scoring (the WAND role): bit-exact parity vs oracle.

The pruned path is a two-phase kernel (tile upper bounds -> exact rescore
of selected tiles) with an exactness certificate; when the certificate
fails the executor escalates to the exhaustive kernel. These tests force
the pruned path onto tiny corpora (prune_min_docs=0) and use both generous
and starved tile budgets so BOTH the safe path and the escalation path are
exercised, always asserting bit-exactness (doc ids, f32 scores, hit
counts) against the scalar oracle.
"""

import numpy as np
import pytest

from diagon_tpu.document import Document, TextField
from diagon_tpu.index.memory_index import MemoryIndex
from diagon_tpu.index.segment import flush_memory_index
from diagon_tpu.search.oracle import OracleSearcher
from diagon_tpu.search.query import BooleanQuery, Occur, TermQuery
from diagon_tpu.search.searcher import IndexSearcher


def _corpus(n_docs=900, vocab=60, seed=11):
    rng = np.random.Generator(np.random.PCG64(seed))
    words = np.asarray(
        [f"w{i}" for i in range(vocab)] + ["oil", "price", "trade", "rare1"],
        dtype=object,
    )
    mem = MemoryIndex()
    for i in range(n_docs):
        ln = max(3, int(rng.normal(20, 8)))
        toks = list(rng.choice(words, ln))
        if i % 317 == 0:
            toks.append("rare1")
        mem.add_document(Document().add(TextField("body", " ".join(toks))))
    return flush_memory_index(mem, "_pr")


def _force_pruned(searcher, field, b0, approx_min_q=None):
    ctx = searcher._ctx(field)
    for ex in ctx.row_executors:
        if ex is not None:
            ex.prune_min_docs = 0
            ex.prune_solo_min_docs = 0
            ex.prune_B0 = b0
            if approx_min_q is not None:
                ex.approx_min_q = approx_min_q
    return ctx


def _or_query(terms):
    b = BooleanQuery.Builder()
    for t in terms:
        b.add(TermQuery("body", t), Occur.SHOULD)
    return b.build()


QUERIES = [
    ["oil"],
    ["oil", "price"],
    ["oil", "price", "trade", "w1", "w2"],
    ["rare1"],
    ["rare1", "oil"],
    ["zzz_missing", "oil"],
    [f"w{i}" for i in range(20)],
]


@pytest.mark.parametrize("approx_min_q", [1, 1000])
@pytest.mark.parametrize("b0", [2, 8, 10_000])
def test_pruned_or_parity(b0, approx_min_q):
    """approx_min_q=1 routes phase 1 through the matmul selection;
    1000 uses per-clause tile-UB rows. Both must be bit-exact."""
    seg = _corpus()
    searcher = IndexSearcher([seg])
    _force_pruned(searcher, "body", b0, approx_min_q)
    oracle = OracleSearcher([seg])
    for terms in QUERIES:
        q = _or_query(terms)
        want = oracle.search(q, 10)
        got = searcher.search(q, 10)
        assert got.doc_ids() == want.doc_ids(), terms
        assert got.total_hits == want.total_hits, terms
        for o, d in zip(want.score_docs, got.score_docs):
            assert o.score == d.score, (terms, o, d)


def test_pruned_dispatch_is_used_and_certificate_honest():
    from diagon_tpu.search import row_engine

    seg = _corpus()
    searcher = IndexSearcher([seg])
    ctx = _force_pruned(searcher, "body", 4)
    ex = ctx.row_executors[0]
    q = _or_query(["oil", "price", "trade"])
    field, plans = searcher._cached_query_plans(q)
    fused = np.asarray(ex.dispatch([plans[0]] * 3, 10))
    # pruned layout: 2k+2 columns (scores, docs, hits, safe flag)
    assert fused.shape[-1] == 22
    # starved budget (4 tiles of ~8) on broad queries: certificate must not
    # be trivially 1 everywhere AND escalated results must match oracle
    oracle = OracleSearcher([seg])
    got = searcher.search(q, 10)
    want = oracle.search(q, 10)
    assert got.doc_ids() == want.doc_ids()
    assert got.total_hits == want.total_hits


@pytest.mark.parametrize("approx_min_q", [1, 1000])
@pytest.mark.parametrize("b0", [2, 64])
def test_pruned_batch_and_async_paths(b0, approx_min_q):
    seg = _corpus(n_docs=700, seed=5)
    searcher = IndexSearcher([seg])
    _force_pruned(searcher, "body", b0, approx_min_q)
    oracle = OracleSearcher([seg])
    queries = [_or_query(t) for t in QUERIES]
    got_batch = searcher.search_batch(queries, 10)
    h = searcher.dispatch_batch(queries, 10)
    got_async = searcher.collect_batch(h)
    h2 = [searcher.dispatch_batch(queries, 10) for _ in range(2)]
    got_many = searcher.collect_many(h2)
    for qi, q in enumerate(queries):
        want = oracle.search(q, 10)
        for got in (got_batch[qi], got_async[qi], got_many[0][qi],
                    got_many[1][qi]):
            assert got.doc_ids() == want.doc_ids(), QUERIES[qi]
            assert got.total_hits == want.total_hits
            for o, d in zip(want.score_docs, got.score_docs):
                assert o.score == d.score


def test_pruned_with_deletes():
    seg = _corpus(n_docs=600, seed=9)
    # delete a band of docs, including likely top scorers
    for d in range(0, 600, 7):
        seg.delete_document(d)
    searcher = IndexSearcher([seg])
    _force_pruned(searcher, "body", 8)
    oracle = OracleSearcher([seg])
    for terms in QUERIES:
        q = _or_query(terms)
        want = oracle.search(q, 10)
        got = searcher.search(q, 10)
        assert got.doc_ids() == want.doc_ids(), terms
        assert got.total_hits == want.total_hits, terms


def test_approx_matmul_upper_bound_sound():
    """The relative certificate bound must dominate the actual bf16 matmul
    error (soundness of the exactness proof): for nonnegative banks,
    true_score <= approx * (1 + 2^-7), and approx > 0 iff true > 0."""
    import jax.numpy as jnp

    from diagon_tpu.search.row_engine import _APPROX_RELEPS

    rng = np.random.Generator(np.random.PCG64(8))
    H, D, Q = 40, 4096, 16
    bank = (rng.random((H, D)) * rng.random((H, 1)) * 14).astype(np.float32)
    bank[rng.random((H, D)) < 0.6] = 0.0
    a = (rng.random((Q, H)) < 0.4).astype(np.float32)
    approx = np.asarray(
        jnp.dot(
            jnp.asarray(a).astype(jnp.bfloat16),
            jnp.asarray(bank).astype(jnp.bfloat16),
            preferred_element_type=jnp.float32,
        )
    )
    exact = a.astype(np.float64) @ bank.astype(np.float64)
    upper = approx * (np.float32(1.0) + _APPROX_RELEPS)
    assert (upper >= exact).all(), float((exact - upper).max())
    assert ((approx > 0) == (exact > 0)).all()


def test_pruned_fuzz_random_or_queries():
    rng = np.random.Generator(np.random.PCG64(42))
    seg = _corpus(n_docs=800, vocab=40, seed=3)
    searcher = IndexSearcher([seg])
    _force_pruned(searcher, "body", 6, approx_min_q=1)
    oracle = OracleSearcher([seg])
    vocab = [f"w{i}" for i in range(40)] + ["oil", "price", "rare1", "nope"]
    for _ in range(25):
        n = int(rng.integers(1, 8))
        terms = list(rng.choice(vocab, n, replace=False))
        k = int(rng.integers(1, 25))
        q = _or_query(terms)
        want = oracle.search(q, k)
        got = searcher.search(q, k)
        assert got.doc_ids() == want.doc_ids(), (terms, k)
        assert got.total_hits == want.total_hits, (terms, k)
        for o, d in zip(want.score_docs, got.score_docs):
            assert o.score == d.score


@pytest.mark.parametrize("b0", [2, 8, 10_000])
def test_pruned_general_boolean_parity(b0):
    """General MUST/FILTER/SHOULD/MUST_NOT batches through the pruned
    matmul kernel (presence-count matmuls + feasibility-gated selection),
    bit-exact vs oracle including starved-budget escalation."""
    seg = _corpus(n_docs=800, seed=31)
    searcher = IndexSearcher([seg])
    _force_pruned(searcher, "body", b0, approx_min_q=1)
    oracle = OracleSearcher([seg])

    def B(*cl, ms=0):
        b = BooleanQuery.Builder()
        for q, o in cl:
            b.add(q, o)
        b.set_minimum_number_should_match(ms)
        return b.build()

    T = lambda t: TermQuery("body", t)
    queries = [
        B((T("oil"), Occur.MUST), (T("price"), Occur.MUST)),
        B((T("oil"), Occur.MUST), (T("w1"), Occur.SHOULD),
          (T("w2"), Occur.SHOULD)),
        B((T("oil"), Occur.FILTER), (T("price"), Occur.SHOULD)),
        B((T("oil"), Occur.SHOULD), (T("price"), Occur.SHOULD),
          (T("w3"), Occur.MUST_NOT)),
        B((T("oil"), Occur.SHOULD), (T("price"), Occur.SHOULD),
          (T("trade"), Occur.SHOULD), ms=2),
        B((T("zzz_missing"), Occur.MUST), (T("oil"), Occur.SHOULD)),
        B((T("oil"), Occur.FILTER)),  # filter-only: score-0 matches
    ]
    for q in queries:
        want = oracle.search(q, 10)
        got = searcher.search(q, 10)
        assert got.doc_ids() == want.doc_ids(), q
        assert got.total_hits == want.total_hits, q
        for o, d in zip(want.score_docs, got.score_docs):
            assert o.score == d.score, (q, o, d)


def test_pruned_general_boolean_fuzz():
    rng = np.random.Generator(np.random.PCG64(123))
    seg = _corpus(n_docs=700, vocab=30, seed=13)
    searcher = IndexSearcher([seg])
    _force_pruned(searcher, "body", 4, approx_min_q=1)
    oracle = OracleSearcher([seg])
    vocab = [f"w{i}" for i in range(30)] + ["oil", "price", "rare1", "nope"]
    occurs = [Occur.MUST, Occur.SHOULD, Occur.FILTER, Occur.MUST_NOT]
    checked = 0
    for _ in range(30):
        n = int(rng.integers(2, 7))
        b = BooleanQuery.Builder()
        n_should = 0
        for _ in range(n):
            o = occurs[int(rng.integers(4))]
            if o == Occur.SHOULD:
                n_should += 1
            b.add(TermQuery("body", str(rng.choice(vocab))), o)
        if n_should and rng.random() < 0.4:
            b.set_minimum_number_should_match(
                int(rng.integers(1, n_should + 1))
            )
        q = b.build()
        if searcher._term_clauses(q) is None:
            continue
        k = int(rng.integers(1, 20))
        want = oracle.search(q, k)
        got = searcher.search(q, k)
        assert got.doc_ids() == want.doc_ids(), q
        assert got.total_hits == want.total_hits, q
        for o_, d_ in zip(want.score_docs, got.score_docs):
            assert o_.score == d_.score
        checked += 1
    assert checked >= 20


@pytest.mark.parametrize("b0", [16, 2])
def test_fused_bool2_kernel_parity(b0):
    """No-MUST_NOT boolean batches take the FUSED 2-matmul phase-1
    kernel (combined rq*256 + sh indicator); batches with negation or a
    row serving both required and should roles for one query must fall
    back to the 4-matmul kernel. Bit-exact either way."""
    seg = _corpus(n_docs=800, seed=77)
    searcher = IndexSearcher([seg])
    ctx = _force_pruned(searcher, "body", b0, approx_min_q=1)
    ex = next(e for e in ctx.row_executors if e is not None)
    oracle = OracleSearcher([seg])

    def B(*cl, ms=0):
        b = BooleanQuery.Builder()
        for q, o in cl:
            b.add(q, o)
        b.set_minimum_number_should_match(ms)
        return b.build()

    T = lambda t: TermQuery("body", t)
    fused_batch = [
        B((T("oil"), Occur.MUST), (T("price"), Occur.MUST)),
        B((T("oil"), Occur.MUST), (T("w1"), Occur.SHOULD),
          (T("w2"), Occur.SHOULD)),
        B((T("oil"), Occur.FILTER), (T("w4"), Occur.SHOULD)),
        B((T("oil"), Occur.FILTER)),  # filter-only: score-0 matches
        B((T("trade"), Occur.MUST), (T("w5"), Occur.SHOULD),
          (T("w6"), Occur.SHOULD), ms=1),
    ] * 3
    got = searcher.search_batch(fused_batch, 10)
    # identical queries dedup before dispatch; scan the cache for the
    # boolean entry that actually ran
    compacts = [e[1][-1] for e in ex._batch_cache.values()
                if e[1][-1] is not None]
    assert compacts and all(
        c.a_cb_t is not None for c in compacts
    ), "expected the fused bool2 bank"
    for q, g in zip(fused_batch, got):
        want = oracle.search(q, 10)
        assert g.doc_ids() == want.doc_ids(), q
        assert g.total_hits == want.total_hits, q
        for o, d in zip(want.score_docs, g.score_docs):
            assert o.score == d.score, (q, o, d)

    # negation in the batch -> no fused bank, still bit-exact
    ex._batch_cache.clear()
    ex._batch_bytes = 0
    neg_batch = fused_batch[:4] + [
        B((T("oil"), Occur.SHOULD), (T("price"), Occur.SHOULD),
          (T("w3"), Occur.MUST_NOT)),
    ]
    got = searcher.search_batch(neg_batch, 10)
    compacts = [e[1][-1] for e in ex._batch_cache.values()
                if e[1][-1] is not None]
    assert compacts and all(c.a_cb_t is None for c in compacts)
    for q, g in zip(neg_batch, got):
        want = oracle.search(q, 10)
        assert g.doc_ids() == want.doc_ids(), q
        assert g.total_hits == want.total_hits, q

    # same row as MUST and SHOULD in one query -> digit overlap -> no
    # fused bank, still bit-exact
    ex._batch_cache.clear()
    ex._batch_bytes = 0
    dup_batch = [
        B((T("oil"), Occur.MUST), (T("oil"), Occur.SHOULD),
          (T("price"), Occur.SHOULD)),
        B((T("trade"), Occur.MUST), (T("w1"), Occur.SHOULD)),
    ] * 4
    got = searcher.search_batch(dup_batch, 10)
    compacts = [e[1][-1] for e in ex._batch_cache.values()
                if e[1][-1] is not None]
    assert compacts and all(c.a_cb_t is None for c in compacts)
    for q, g in zip(dup_batch, got):
        want = oracle.search(q, 10)
        assert g.doc_ids() == want.doc_ids(), q
        assert g.total_hits == want.total_hits, q


def test_q_bucket_padding_parity():
    """Batch sizes just past each Q-bucket boundary pad with the
    match-nothing plan; padded results slice away, parity holds."""
    seg = _corpus(n_docs=600, vocab=40, seed=5)
    searcher = IndexSearcher([seg])
    _force_pruned(searcher, "body", 16, approx_min_q=1)
    oracle = OracleSearcher([seg])
    terms = [f"w{i}" for i in range(30)] + ["oil", "price"]
    for n in (1, 2, 3, 5, 7, 9, 63, 65, 129):
        qs = [TermQuery("body", terms[i % len(terms)]) for i in range(n)]
        got = searcher.search_batch(qs, 10)
        for q, g in zip(qs, got):
            want = oracle.search(q, 10)
            assert g.doc_ids() == want.doc_ids(), (n, q)
            assert g.total_hits == want.total_hits, (n, q)


def _rescore_numpy(bank, cidx, tsel, flags):
    """Sequential per-lane f32 adds in clause order — the oracle's
    accumulation — over the selected tiles of a tile-major bank."""
    Q, Tq = cidx.shape
    B = tsel.shape[1]
    LANE = bank.shape[2]
    outs = [np.zeros((Q, B, LANE), np.float32) for _ in range(4)]
    for q in range(Q):
        for t in range(Tq):
            rows = bank[tsel[q], cidx[q, t]]  # [B, LANE]
            fl = 1 if flags is None else int(flags[q, t])
            pres = (rows > 0).astype(np.float32)
            for bit, (o, v) in enumerate(
                zip(outs, (rows, pres, pres, pres))
            ):
                if fl & (1 << bit):
                    o[q] = (o[q] + v).astype(np.float32)
    return outs[0] if flags is None else tuple(outs)


@pytest.mark.parametrize(
    "boolean,Q,B,Tq,U8",
    [
        (False, 8, 1, 4, 16),  # one tile per query
        (False, 13, 8, 20, 32),  # ragged Q, wide OR
        (False, 64, 24, 5, 16),  # heavy tile overlap across queries
        (True, 8, 1, 4, 16),
        (True, 13, 8, 20, 32),
        (True, 64, 24, 5, 16),
        (True, 3, 40, 8, 64),  # B wider than Q
        (False, 1, 6, 4, 128),
    ],
)
def test_rescore_compact_matches_sequential_numpy(boolean, Q, B, Tq, U8):
    """Phase 2 (rescore_compact) vs a numpy sequential-add reference:
    bit-identical [Q, B, LANE] scores and, for booleans, req/sho/neg
    presence counts, for arbitrary cidx/tsel/flags including the zero
    row and tiles shared across queries."""
    import jax.numpy as jnp

    from diagon_tpu.search.row_engine import rescore_compact

    rng = np.random.Generator(np.random.PCG64(Q * 131 + B * 7 + Tq))
    G, LANE = 48, 128
    bank = rng.normal(size=(G, U8, LANE)).astype(np.float32) * 3
    bank[:, 0, :] = 0.0  # row 0 is the zero row
    bank[bank < 0] = 0.0  # score rows are nonnegative
    cidx = rng.integers(0, U8, size=(Q, Tq)).astype(np.int32)
    tsel = np.sort(
        np.stack([rng.choice(G - 8, size=B, replace=False)
                  for _ in range(Q)]),
        axis=1,
    ).astype(np.int32)
    flags = (
        rng.integers(0, 16, size=(Q, Tq)).astype(np.int32)
        if boolean else None
    )
    got = rescore_compact(
        jnp.asarray(bank), jnp.asarray(cidx), jnp.asarray(tsel),
        None if flags is None else jnp.asarray(flags),
    )
    want = _rescore_numpy(bank, cidx, tsel, flags)
    if not boolean:
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for x, y in zip(got, want):
        assert np.asarray(x).shape == (Q, B, LANE)
        assert np.array_equal(np.asarray(x), y)


def test_query_cache_p1_replay_bit_exact():
    """LRUQueryCache role: re-issuing an identical batch on the staged
    (huge-segment) path replays cached phase-1 state and must stay
    bit-exact vs both the oracle and a cache-disabled searcher."""
    seg = _corpus(n_docs=700, seed=5)
    cached = IndexSearcher([seg], query_cache=True)
    uncached = IndexSearcher([seg], query_cache=False)
    oracle = OracleSearcher([seg])
    queries = [_or_query(t) for t in QUERIES]
    for s in (cached, uncached):
        ctx = _force_pruned(s, "body", 64, approx_min_q=1)
        for ex in ctx.row_executors:
            if ex is not None:
                ex.batch_only_min_docs = 0  # force the staged pipeline
    first = cached.search_batch(queries, 10)
    # the cache held per-(batch, segment) phase-1 state after dispatch 1
    ctx = cached._ctx("body")
    ex = next(e for e in ctx.row_executors if e is not None)
    assert any(
        entry[1][-1] is not None and entry[1][-1].p1_cache
        for entry in ex._batch_cache.values()
    ), "p1 cache never populated on the staged path"
    replay = cached.search_batch(queries, 10)  # p1 replayed
    base = uncached.search_batch(queries, 10)
    for qi, q in enumerate(queries):
        want = oracle.search(q, 10)
        for got in (first[qi], replay[qi], base[qi]):
            assert got.doc_ids() == want.doc_ids(), QUERIES[qi]
            assert got.total_hits == want.total_hits
            for o, d in zip(want.score_docs, got.score_docs):
                assert o.score == d.score
    # the uncached searcher must not have populated any p1 cache
    uctx = uncached._ctx("body")
    for uex in uctx.row_executors:
        if uex is None:
            continue
        for entry in uex._batch_cache.values():
            compact = entry[1][-1]
            assert compact is None or not compact.p1_cache
