"""On-demand bank mode (huge segments): bit-exact parity vs oracle.

Segments past ON_DEMAND_MIN_DOCS hold NO resident heavy bank (8.6 GB at
10M docs — the r3 10M-mixed OOM); per-batch compact banks scatter-build
from the packed postings instead. These tests force that mode onto a
tiny corpus (threshold patched down, flat-scatter limit patched down so
the grouped build path runs) and assert bit-exactness against the
oracle for single queries, batches, booleans, counts, and escalations.
"""

import numpy as np
import pytest

from diagon_tpu.document import Document, TextField
from diagon_tpu.index.memory_index import MemoryIndex
from diagon_tpu.index.segment import flush_memory_index
from diagon_tpu.search import row_engine
from diagon_tpu.search.oracle import OracleSearcher
from diagon_tpu.search.query import BooleanClause, BooleanQuery, Occur, TermQuery
from diagon_tpu.search.searcher import IndexSearcher


def _corpus(n_docs=900, vocab=30, seed=11):
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
    return flush_memory_index(mem, "_od")


@pytest.fixture()
def od_searcher(monkeypatch):
    monkeypatch.setattr(
        row_engine.RowFieldIndex, "ON_DEMAND_MIN_DOCS", 512
    )
    # force the grouped (multi-chunk) row build: <=4 rows per flat scatter
    seg = _corpus()
    d_pad = 1024
    monkeypatch.setattr(row_engine, "_FLAT_SCATTER_MAX", 5 * d_pad)
    s = IndexSearcher([seg])
    ctx = s._ctx("body")
    for ex in ctx.row_executors:
        if ex is not None:
            ex.prune_min_docs = 0
            ex.prune_solo_min_docs = 0
    return s, OracleSearcher([seg])


def _assert_parity(s, oracle, q, k=10):
    want = oracle.search(q, k)
    got = s.search(q, k)
    assert got.doc_ids() == want.doc_ids()
    assert got.total_hits == want.total_hits
    for o, g in zip(want.score_docs, got.score_docs):
        assert o.score == g.score


def _or(terms):
    return BooleanQuery(
        [BooleanClause(TermQuery("body", t), Occur.SHOULD) for t in terms]
    )


def test_on_demand_mode_active(od_searcher):
    s, _ = od_searcher
    ex = s._ctx("body").row_executors[0]
    assert ex.index.bank_on_demand
    assert ex.index.heavy_bank is None
    assert ex.index.heavy_ub is None
    # and heavy terms were still classified
    assert (ex.index.heavy_row_of_term >= 0).any()


def test_on_demand_single_queries_bit_exact(od_searcher):
    s, oracle = od_searcher
    _assert_parity(s, oracle, TermQuery("body", "oil"))
    _assert_parity(s, oracle, TermQuery("body", "rare1"))
    _assert_parity(s, oracle, _or(["oil", "price", "w0", "w7"]))
    _assert_parity(
        s, oracle,
        BooleanQuery([
            BooleanClause(TermQuery("body", "oil"), Occur.MUST),
            BooleanClause(TermQuery("body", "price"), Occur.SHOULD),
            BooleanClause(TermQuery("body", "rare1"), Occur.MUST_NOT),
        ]),
    )


def test_on_demand_batch_bit_exact(od_searcher):
    s, oracle = od_searcher
    batch = [
        _or(["oil", "price"]),
        _or(["w0", "w1", "w2", "trade"]),
        TermQuery("body", "w5"),
        BooleanQuery([
            BooleanClause(TermQuery("body", "w3"), Occur.MUST),
            BooleanClause(TermQuery("body", "oil"), Occur.SHOULD),
        ]),
        BooleanQuery(
            [
                BooleanClause(TermQuery("body", t), Occur.SHOULD)
                for t in ("w1", "w2", "w4", "price")
            ],
            minimum_number_should_match=2,
        ),
    ] * 3
    handles = s.dispatch_batch(batch, 10)
    res = s.collect_batch(handles)
    for q, td in zip(batch, res):
        want = oracle.search(q, 10)
        assert td.doc_ids() == want.doc_ids()
        assert td.total_hits == want.total_hits
        for o, g in zip(want.score_docs, td.score_docs):
            assert o.score == g.score


def test_on_demand_phase0_engages_and_bit_exact(od_searcher):
    """The phase-0 route (tile-maxima selection + bitmap hit counts)
    must actually engage for min_should<=1 on-demand batches — and stay
    bit-exact across pure-OR, MUST+SHOULD, FILTER, MUST_NOT, and a
    dead query (absent required term). Phase-0 is opt-in (default off),
    so enable it on the executors first."""
    s, oracle = od_searcher
    for ex in s._ctx("body").row_executors:
        if ex is not None:
            ex.use_phase0 = True
    batch = [
        _or(["oil", "price", "w7"]),
        TermQuery("body", "trade"),
        BooleanQuery([
            BooleanClause(TermQuery("body", "w3"), Occur.MUST),
            BooleanClause(TermQuery("body", "oil"), Occur.SHOULD),
            BooleanClause(TermQuery("body", "w9"), Occur.SHOULD),
        ]),
        BooleanQuery([
            BooleanClause(TermQuery("body", "w1"), Occur.FILTER),
            BooleanClause(TermQuery("body", "price"), Occur.SHOULD),
        ]),
        BooleanQuery([
            BooleanClause(TermQuery("body", "w2"), Occur.MUST),
            BooleanClause(TermQuery("body", "rare1"), Occur.MUST_NOT),
        ]),
        BooleanQuery([
            BooleanClause(TermQuery("body", "zz_absent"), Occur.MUST),
            BooleanClause(TermQuery("body", "oil"), Occur.SHOULD),
        ]),
    ] * 2
    handles = s.dispatch_batch(batch, 10)
    res = s.collect_batch(handles)
    for q, td in zip(batch, res):
        want = oracle.search(q, 10)
        assert td.doc_ids() == want.doc_ids(), q
        assert td.total_hits == want.total_hits, q
        for o, g in zip(want.score_docs, td.score_docs):
            assert o.score == g.score
    # the dispatch must have built phase-0 entries (ubank + bits), not
    # the bf16 phase-1 banks
    ex = next(
        e for e in s._ctx("body").row_executors if e is not None
    )
    compacts = [
        entry[1][-1]
        for entry in ex._batch_cache.values()
        if entry[1][-1] is not None
    ]
    assert compacts, "no compact entries were built"
    assert any(c.ubank is not None for c in compacts)
    for c in compacts:
        if c.ubank is not None:
            assert c.compact_bf16 is None  # phase-0 entries skip bf16
            assert c.bits is not None and c.qmode is not None


def test_on_demand_count_and_escalation(od_searcher):
    s, oracle = od_searcher
    # count() exercises _args -> _demand_heavy_args
    q = _or(["oil", "price", "w0"])
    assert s.count(q) == oracle.search(q, 10).total_hits
    # starved tile budget forces certificate escalation through the
    # on-demand exhaustive bank
    for ex in s._ctx("body").row_executors:
        if ex is not None:
            ex.prune_B0 = 1
    _assert_parity(s, oracle, _or(["oil", "price", "trade", "w2"]), k=20)
