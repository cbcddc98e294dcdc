"""The exactness facts the scoring contract rests on (docs/DESIGN.md §2).

1. No device multiply on the score path, so a fused multiply-add that
   XLA may form cannot change a score: checked structurally here on any
   backend, and as bit-exact scores against numpy on the card.
2. Integer counts and doc ids cross the fused f32 outputs as exact f32
   VALUES below 2^24 (never as bit patterns, which a flush-to-zero mode
   would destroy).
3. The phase-1 bound ``exact <= approx * (1 + 2^-7)`` holds for the
   kernel the card runs, at the 10M-doc width.

Tests taking the ``gpu_device`` fixture skip without an NVIDIA card;
``python chip_smoke.py`` runs them on it.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from diagon_tpu.search import row_engine  # noqa: E402

LANE = 128


def _float_muls(jaxpr):
    """Float ``mul`` equations anywhere in a (closed) jaxpr, sub-jaxprs
    of scans / jits / conds included."""
    found = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "mul" and jnp.issubdtype(
            eqn.outvars[0].aval.dtype, jnp.floating
        ):
            found.append(eqn)
        for p in eqn.params.values():
            subs = p if isinstance(p, (list, tuple)) else [p]
            for sub in subs:
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    found += _float_muls(inner)
    return found


def _score_path_programs():
    G, U8, Q, Tq, B, H, D = 16, 16, 4, 8, 4, 6, 16 * LANE
    ct = jnp.zeros((G, U8, LANE), jnp.float32)
    cidx = jnp.zeros((Q, Tq), jnp.int32)
    tsel = jnp.zeros((Q, B), jnp.int32)
    bank = jnp.zeros((H, D), jnp.float32)
    live = jnp.ones((D,), jnp.float32)
    hidx = jnp.zeros((Q, Tq), jnp.int32)
    return {
        "rescore_or": (row_engine.rescore_compact, (ct, cidx, tsel)),
        "rescore_bool": (
            row_engine.rescore_compact, (ct, cidx, tsel, cidx)
        ),
        "exhaustive_or": (
            lambda *a: row_engine.row_score_topk_pure_or(*a, k=10),
            (bank, bank[:1], live, hidx, hidx),
        ),
    }


@pytest.mark.parametrize(
    "name", ["exhaustive_or", "rescore_bool", "rescore_or"]
)
def test_score_path_has_no_float_multiply(name):
    fn, args = _score_path_programs()[name]
    jaxpr = jax.make_jaxpr(fn)(*args)
    assert not _float_muls(jaxpr.jaxpr), name


def _rescore_numpy(bank, cidx, tsel):
    acc = np.zeros((*tsel.shape, LANE), np.float32)
    for t in range(cidx.shape[1]):
        acc = (acc + bank[tsel, cidx[:, t][:, None]]).astype(np.float32)
    return acc


@pytest.mark.gpu
def test_rescore_bit_exact_on_gpu(gpu_device):
    """Phase 2 at the serving width (Q=1024, B=24, Tq=20) on the card
    equals numpy's sequential f32 adds bit for bit."""
    rng = np.random.Generator(np.random.PCG64(2))
    G, U8, Q, Tq, B = 7816, 32, 1024, 20, 24
    bank = (rng.random((G, U8, LANE), np.float32) * 7).astype(np.float32)
    bank[:, 0] = 0.0
    cidx = rng.integers(0, U8, (Q, Tq)).astype(np.int32)
    tsel = np.sort(rng.integers(0, G, (Q, B)), axis=1).astype(np.int32)
    put = lambda a: jax.device_put(a, gpu_device)
    got = np.asarray(
        row_engine.rescore_compact(put(bank), put(cidx), put(tsel))
    )
    assert np.array_equal(got, _rescore_numpy(bank, cidx, tsel))


@pytest.mark.gpu
def test_search_bit_exact_on_gpu(gpu_device):
    """Pruned and exhaustive batch paths on the card vs the oracle."""
    from diagon_tpu.document import Document, TextField
    from diagon_tpu.index.memory_index import MemoryIndex
    from diagon_tpu.index.segment import flush_memory_index
    from diagon_tpu.search.oracle import OracleSearcher
    from diagon_tpu.search.query import BooleanQuery, Occur, TermQuery
    from diagon_tpu.search.searcher import IndexSearcher

    rng = np.random.Generator(np.random.PCG64(5))
    words = [f"w{i}" for i in range(50)]
    mem = MemoryIndex()
    for _ in range(3000):
        toks = rng.choice(words, max(3, int(rng.normal(20, 6))))
        mem.add_document(Document().add(TextField("body", " ".join(toks))))
    seg = flush_memory_index(mem, "_g")
    oracle = OracleSearcher([seg])

    def q(terms, occ=Occur.SHOULD):
        b = BooleanQuery.Builder()
        for t in terms:
            b.add(TermQuery("body", t), occ)
        return b.build()

    batch = [q(words[i: i + 5]) for i in range(0, 40, 2)] + [
        q(["w1", "w2"], Occur.MUST), q(["w3", "w9"], Occur.MUST),
    ] * 4
    for prune in (True, False):
        s = IndexSearcher([seg])
        for ex in s._ctx("body").row_executors:
            ex.prune_min_docs = 0 if prune else 1 << 40
            ex.prune_solo_min_docs = 0
        for query, got in zip(batch, s.search_batch(batch, 10)):
            want = oracle.search(query, 10)
            assert got.doc_ids() == want.doc_ids()
            assert got.total_hits == want.total_hits
            assert [d.score for d in got.score_docs] == [
                d.score for d in want.score_docs
            ]


@pytest.mark.gpu
def test_counts_cross_f32_exactly_on_gpu(gpu_device):
    """Doc ids and hit counts below 2^24 survive the f32 fused layout on
    the card, including values whose bit patterns are denormals."""
    ints = np.concatenate([
        np.arange(0, 4096), np.arange((1 << 24) - 4096, 1 << 24),
    ]).astype(np.int32)

    @jax.jit
    def roundtrip(x):
        f = jnp.concatenate([x.astype(jnp.float32), jnp.ones((1,))])
        return (f + jnp.float32(0.0))[:-1].astype(jnp.int32)

    got = np.asarray(roundtrip(jax.device_put(ints, gpu_device)))
    assert np.array_equal(got, ints)


@pytest.mark.gpu
def test_phase1_bound_sound_at_10m_on_gpu(gpu_device):
    """The card's phase-1 tile maxima bound the exact f32 tile maxima at
    the 10M-doc width: exact <= tmax * (1 + 2^-7) on every tile, and the
    hit counts equal the exact match counts."""
    from diagon_tpu.ops.approx import approx_select

    rng = np.random.Generator(np.random.PCG64(8))
    H, Q, D = 32, 16, 10_000_384
    bank = (rng.random((H, D), np.float32) * 14).astype(np.float32)
    bank[rng.random((H, D)) < 0.6] = 0.0
    bank[0] = 0.0
    a = (rng.random((H, Q)) < 0.4).astype(np.float32)
    live = np.ones(D, np.float32)
    put = lambda x: jax.device_put(x, gpu_device)
    tmax, hits = approx_select(
        put(bank).astype(jnp.bfloat16), put(live),
        put(a).astype(jnp.bfloat16),
    )
    exact = np.zeros((Q, D), np.float32)
    for r in range(H):
        exact = (exact + a[r][:, None] * bank[r][None, :]).astype(
            np.float32
        )
    ex_t = exact.reshape(Q, D // LANE, LANE).max(axis=2)
    upper = np.asarray(tmax) * (np.float32(1.0) + row_engine._APPROX_RELEPS)
    assert (ex_t <= upper).all()
    assert np.array_equal(np.asarray(hits), (exact > 0).sum(axis=1))
