"""Row-bank scoring engine — contiguous-row scoring.

The engine's inner loops read whole contiguous rows and do elementwise
math; nothing gathers or scatters per posting on the query path.

So the index view for scoring is **one dense f32 score row per term over
the padded doc space** (the exact BM25 contribution of that term to every
doc — idf already folded in, host-computed in numpy float32):

- **Heavy terms** (df >= num_docs/HEAVY_FRACTION): rows live in a device
  bank ``[H, D]`` built once per searcher.
- **Light terms** (and boosted clauses): rows are densified on the host at
  plan time (df is small, so it's a few microseconds) and uploaded as a
  tiny per-plan bank; plans are cached.

A query is then: ``scan`` over its clauses in oracle order, each step = one
row gather (contiguous) + one masked add; boolean counts are elementwise
indicator adds on the same rows; one ``top_k`` at the end. No multiplies
(FMA-proof), no element gathers, no scatters. Bit-exact vs the oracle.

This is the logical extreme of the SURVEY.md section 7 design: the
"[term, block] impact table" becomes the score row itself — the
accelerator's answer to the reference's postings traversal is to not
traverse at all.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from functools import partial
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from diagon_tpu.ops.approx import bank_rows

LANE = 128  # docs per tile
HEAVY_FRACTION = 16  # heavy iff df >= num_docs_pad / HEAVY_FRACTION
HEAVY_MIN_DF = 256

# Block-max pruned scoring (the WAND role, WANDScorer.h:17-285): engage the
# two-phase kernel once a segment is large enough that exhaustive [Tq, D]
# row traffic dominates; below ~16k docs the fixed phase-1/select cost
# loses to the tiny exhaustive pass.
PRUNE_MIN_DOCS = 1 << 14
# Initial candidate-tile budget per query. The selection phase is
# near-exact (bf16-relative bound), so the true top-k live in <= k tiles;
# 24 leaves a tie margin and the certificate escalates when starved
# (fewer tiles trade phase-2 work for escalations).
PRUNE_B0 = 24

# On-demand bank mode: segments at least this large do NOT materialize a
# resident heavy bank (f32 rows for ~200 heavy terms = 8.6 GB at 10M docs,
# which would crowd out the per-batch compact banks on a 16 GB budget).
# Instead every batch's compact bank is scatter-built from the
# resident packed postings for exactly the rows it uses (LRU-cached).
# This is the equal-memory form of the WAND role at scale
# (WANDScorer.h:17-285 streams blocks; it never holds dense rows).
BANK_ON_DEMAND_MIN_DOCS = 4 << 20


def _bucket(n: int, minimum: int = 8) -> int:
    return max(minimum, 1 << math.ceil(math.log2(max(1, n))))


def _bucket_tq(n: int) -> int:
    """Clause-count bucket: multiples of 4 up to 24, then powers of two.
    Each scan step costs full [Q, D] traffic, so tight buckets matter."""
    if n <= 24:
        return max(4, ((n + 3) // 4) * 4)
    return 1 << math.ceil(math.log2(n))


def exact_topk(final: jnp.ndarray, k: int):
    """(scores desc, docid asc) top-k over a dense [D] score vector.

    For large D, a two-stage exact selection: per-128-tile maxima -> top-k
    tiles -> top-k within their lanes. Exactness: if a true top-k doc's
    tile were excluded, each of the k selected tiles has max >= that doc's
    score, and for ties the selected tile's max-doc has a lower docid
    (lower tile index), so k docs outrank it — contradiction. The final
    ordering is restored with a lexicographic (score desc, docid asc) sort
    over the k*128 candidates.
    """
    D = final.shape[0]
    if D <= 32768 or D % LANE != 0:
        return jax.lax.top_k(final, k)  # ties -> lower index == lower docid
    G = D // LANE
    # k tiles suffice for exactness; when k > G select all G tiles (the
    # candidate set is then the whole array).
    kt = min(k, G)
    tiles = final.reshape(G, LANE)
    tmax = jnp.max(tiles, axis=1)
    _, tidx = jax.lax.top_k(tmax, kt)  # ties -> lower tile index
    cand = tiles[tidx]  # [kt, LANE] contiguous row gather
    cand_docs = (
        tidx[:, None] * LANE
        + jax.lax.broadcasted_iota(jnp.int32, (1, LANE), 1)
    ).reshape(-1)
    flat = cand.reshape(-1)
    neg, docs_sorted = jax.lax.sort(
        (jnp.negative(flat), cand_docs), dimension=0, is_stable=True,
        num_keys=2,
    )
    return -neg[:k], docs_sorted[:k]


def _row_for(hi, li, heavy_bank, light_bank):
    """Select this clause's dense row; skips the light-bank gather at trace
    time when the plan batch carries no host rows (bank is just the zero
    row) — halves the gather traffic for the common all-heavy case."""
    row_h = heavy_bank[jnp.maximum(hi, 0)]
    if light_bank.shape[0] == 1:
        return jnp.where(hi >= 0, row_h, jnp.float32(0.0))
    row_l = light_bank[jnp.maximum(li, 0)]
    return jnp.where(hi >= 0, row_h, row_l)


@partial(jax.jit, static_argnames=("k",))
def row_score_topk_pure_or(
    heavy_bank,  # f32 [H, D]
    light_bank,  # f32 [L, D]
    live,  # f32 [D]
    hidx,  # int32 [Q, Tq]
    lidx,  # int32 [Q, Tq]
    *,
    k: int,
):
    """Pure-disjunction fast path (SHOULD-only, minShouldMatch <= 1): a doc
    matches iff its score is positive (contributions are positive), so no
    count grids ride the scan — one f32 carry instead of four. Each scan
    step unrolls 4 sequential adds (left-to-right, oracle order preserved)
    so the carry stays in registers across the group instead of making an
    HBM round-trip per clause."""
    UNROLL = 4

    def one_query(hidx_q, lidx_q):
        Tq = hidx_q.shape[0]
        hi_g = hidx_q.reshape(Tq // UNROLL, UNROLL)
        li_g = lidx_q.reshape(Tq // UNROLL, UNROLL)

        def step(scores, inp):
            hi, li = inp
            for j in range(UNROLL):
                scores = scores + _row_for(
                    hi[j], li[j], heavy_bank, light_bank
                )
            return scores, None

        D = heavy_bank.shape[1]
        scores, _ = jax.lax.scan(
            step, jnp.zeros((D,), jnp.float32), (hi_g, li_g)
        )
        mask = (scores > 0) & (live > 0)
        final = jnp.where(mask, scores, jnp.float32(-1.0))
        top_scores, top_docs = exact_topk(final, k)
        hits = jnp.sum(mask.astype(jnp.int32))
        return jnp.concatenate(
            [
                top_scores,
                top_docs.astype(jnp.float32),
                hits[None].astype(jnp.float32),
            ]
        )

    return jax.vmap(one_query)(hidx, lidx)


# ---------------------------------------------------------------------------
# Block-max pruned scoring (the WAND equivalent)
# ---------------------------------------------------------------------------
#
# Two-phase exact top-k, the batched answer to the reference's Block-Max WAND
# (WANDScorer.h:17-285) and MaxScoreBulkScorer (MaxScoreBulkScorer.h:18-120):
#
# 1. A cheap vectorized upper-bound pass over per-(term, 128-doc-tile)
#    score maxima selects the B most promising tiles per query, and a
#    bitmap pass (presence bits, 1 bit/doc) computes the EXACT hit count.
# 2. Only the selected tiles' score rows are gathered (contiguous 512-byte
#    tile DMAs) and rescored in oracle clause order — per-doc f32 adds are
#    the identical sequence the exhaustive kernel performs, so scores stay
#    bit-exact.
#
# Exactness guarantee: let theta be the k-th best rescored candidate and
# u_next the (B+1)-th largest tile upper bound. If theta > u_next, no doc in
# an unselected tile can reach the top k (its score <= its tile's UB <=
# u_next < theta), and no tie-break ambiguity exists (strict inequality).
# Otherwise the kernel flags the query and the executor re-runs it on the
# exhaustive path — a superset rescore, so results are always bit-exact.


@jax.jit
def _tile_aux_rows(rows):
    N, D = rows.shape
    ub = rows.reshape(N, D // LANE, LANE).max(axis=-1)
    v = (rows > 0).astype(jnp.uint32).reshape(N, D // 32, 32)
    w = v << jax.lax.broadcasted_iota(jnp.uint32, v.shape, 2)
    return ub, w.sum(axis=-1, dtype=jnp.uint32)


@partial(jax.jit, static_argnames=("rows",))
def _tile_aux_slice(bank, start, *, rows):
    """Aux for bank[start:start+rows], sliced INSIDE the jit: an outside
    slice materializes a row-chunk buffer at enqueue time, and with async
    dispatch every chunk's buffer can coexist before any executes.
    In-program slices are scoped temps that only exist while their
    program runs."""
    sl = jax.lax.dynamic_slice_in_dim(bank, start, rows, 0)
    return _tile_aux_rows(sl)


def build_tile_aux(bank):
    """Per-row tile maxima + presence bitmaps for a dense row bank.

    bank f32 [N, D] -> (ub f32 [N, D/128], bits u32 [N, D/32]).
    Bit j of word w covers doc w*32+j (must match _pack_live_bits).
    Processed in row chunks: the (bank > 0) u32 intermediate is
    bank-sized, which OOM'd next to a 6 GB bank at 10M docs.
    """
    N, D = bank.shape
    C = max(1, (1 << 28) // max(1, D))  # ~1 GB u32 temp per chunk
    if N <= C:
        return _tile_aux_rows(bank)
    ubs, bits = [], []
    for i in range(0, N, C):
        rows = min(C, N - i)
        u, b = _tile_aux_slice(bank, jnp.int32(i), rows=rows)
        ubs.append(u)
        bits.append(b)
    return jnp.concatenate(ubs), jnp.concatenate(bits)


@jax.jit
def _tile_major(bank):
    """[U8, D] -> [G, U8, LANE] tile-major relayout (module-level jit so
    repeated bank builds at a bucketed shape reuse one compile — an
    inline lambda here cost a fresh XLA compile per batch)."""
    U8, D = bank.shape
    return bank.reshape(U8, D // LANE, LANE).transpose(1, 0, 2)


@jax.jit
def _pack_live_bits(live):
    """f32 [D] 0/1 -> u32 [D/32] presence bitmap (same packing as
    build_tile_aux)."""
    v = (live > 0).astype(jnp.uint32).reshape(-1, 32)
    w = v << jax.lax.broadcasted_iota(jnp.uint32, v.shape, 1)
    return w.sum(axis=-1, dtype=jnp.uint32)


def _bitmap_hits_q(hidx_q, lidx_q, heavy_bits, light_bits, live_bits,
                   light_small):
    """Exact hit count for one pure-OR query: popcount of the live-masked
    union of per-clause presence bitmaps (u32 words, 1 bit/doc)."""
    G4 = heavy_bits.shape[1]

    def step(bits, inp):
        hi, li = inp
        bth = heavy_bits[jnp.maximum(hi, 0)]
        if light_small:
            btr = jnp.where(hi >= 0, bth, jnp.uint32(0))
        else:
            btr = jnp.where(hi >= 0, bth, light_bits[jnp.maximum(li, 0)])
        return bits | btr, None

    bits, _ = jax.lax.scan(
        step, jnp.zeros((G4,), jnp.uint32), (hidx_q, lidx_q)
    )
    return jnp.sum(jax.lax.population_count(bits & live_bits)).astype(
        jnp.int32
    )


# per-query mode words for bits_hits (computed on host by the executor)
MODE_REQ = 1  # query has required clauses (all present): AND them
MODE_SHO = 2  # query needs >= 1 should match (min_should >= 1 or no req)
MODE_DEAD = 4  # query can never match (absent required clause): hits 0


@partial(jax.jit, static_argnames=("batch",))
def bits_hits(bits, cidx, cflags, qmode, *, batch: int = 32):
    """Exact live hit counts i32 [Q] from presence bitmaps.

    ``bits`` u32 [U8, W]: bit d%32 of word d/32 of row r is set iff row r
    matches LIVE doc d (``_bits_place_chunk``). Per query the boolean
    algebra is exact:

      match = (REQ ? AND of required rows : ~0)
              & (SHO ? OR of should rows : ~0) & ~(OR of must_not rows)

    which equals the oracle's match set when min_should <= 1 and every
    required clause is present (the caller sets MODE_DEAD otherwise).
    Queries run ``batch`` at a time so the [batch, W] word carries stay
    small at any doc count."""
    W = bits.shape[1]
    ones = jnp.full((W,), 0xFFFFFFFF, jnp.uint32)
    zeros = jnp.zeros((W,), jnp.uint32)

    def one(args):
        c_q, f_q, mode = args

        def step(carry, inp):
            band, bor, bneg = carry
            c, fl = inp
            row = bits[c]
            band = jnp.where((fl & 2) != 0, band & row, band)
            bor = jnp.where((fl & 4) != 0, bor | row, bor)
            bneg = jnp.where((fl & 8) != 0, bneg | row, bneg)
            return (band, bor, bneg), None

        (band, bor, bneg), _ = jax.lax.scan(
            step, (ones, zeros, zeros), (c_q, f_q)
        )
        m = (
            jnp.where((mode & MODE_REQ) != 0, band, ones)
            & jnp.where((mode & MODE_SHO) != 0, bor, ones)
            & ~bneg
        )
        m = jnp.where((mode & MODE_DEAD) != 0, zeros, m)
        return jnp.sum(jax.lax.population_count(m).astype(jnp.int32))

    return jax.lax.map(one, (cidx, cflags, qmode), batch_size=batch)


def rescore_compact(compact_t, cidx, tsel, flags=None):
    """Phase 2: exact per-(query, tile) scores from the batch-compact
    tile-major bank.

    ``compact_t`` f32 [G, U8, LANE], ``cidx`` i32 [Q, Tq] compact row per
    clause (0 = the zero row), ``tsel`` i32 [Q, B] selected tiles,
    ``flags`` i32 [Q, Tq] (bit0 scoring / 1 req / 2 sho / 3 neg) or None
    for pure-OR. A scan over the clause axis gathers one contiguous
    512-byte row per (query, tile) and adds it into a [Q, B, LANE] f32
    carry: per lane the adds run sequentially in oracle clause order, the
    same sequence the exhaustive scan performs, so scores are bit-exact.
    The boolean form also returns the req/sho/neg presence counts."""
    G, U8, _ = compact_t.shape
    Q, B = tsel.shape
    flat = compact_t.reshape(G * U8, LANE)
    base = tsel * jnp.int32(U8)  # [Q, B]
    zero = jnp.zeros((Q, B, LANE), jnp.float32)
    if flags is None:

        def step(acc, c):
            return acc + flat[base + c[:, None]], None

        acc, _ = jax.lax.scan(step, zero, cidx.T)
        return acc

    def step_b(carry, inp):
        s, r, o, n = carry
        c, fl = inp
        row = flat[base + c[:, None]]
        fl = fl[:, None, None]
        pres = jnp.where(row > 0, jnp.float32(1.0), jnp.float32(0.0))
        s = s + jnp.where((fl & 1) != 0, row, zero)
        r = r + jnp.where((fl & 2) != 0, pres, zero)
        o = o + jnp.where((fl & 4) != 0, pres, zero)
        n = n + jnp.where((fl & 8) != 0, pres, zero)
        return (s, r, o, n), None

    out, _ = jax.lax.scan(step_b, (zero,) * 4, (cidx.T, flags.T))
    return out


def _rescore_tiles_q(hidx_q, lidx_q, tsel, heavy_tiles, light_tiles, G,
                     light_small):
    """Exact scores for the selected tiles, accumulated in oracle clause
    order — per-doc f32 adds are the identical sequence the exhaustive
    kernel performs, so scores are bit-exact. Scattered per-(clause,
    tile) 512-byte row gathers from the full banks: the SMALL-batch
    tile-UB path; query batches rescore from the batch-compact bank
    (rescore_compact)."""

    def step(scores, inp):
        hi, li = inp
        rowh = heavy_tiles[jnp.maximum(hi, 0) * G + tsel]
        if light_small:
            rows = jnp.where(hi >= 0, rowh, jnp.float32(0.0))
        else:
            rowl = light_tiles[jnp.maximum(li, 0) * G + tsel]
            rows = jnp.where(hi >= 0, rowh, rowl)
        return scores + rows, None

    scores, _ = jax.lax.scan(
        step,
        jnp.zeros((tsel.shape[0], LANE), jnp.float32),
        (hidx_q, lidx_q),
    )
    return scores


def _topk_in_tiles_q(scores, tsel, live_tiles, k):
    """(score desc, docid asc) top-k within selected tiles. REQUIRES tsel
    ascending (docid-ordered tiles).

    Two-stage exact selection (a full sort of B*128 candidates costs
    log^2(B*128) bitonic passes): top-k TILES by max score — lax.top_k
    breaks ties toward the lower tile index, which with ascending tsel is
    the lower docid — then one lexicographic sort of the k*128 surviving
    lanes. Exactness: if a true top-k doc's tile were excluded, each
    selected tile contains a doc that outranks it (higher max, or equal
    max in a lower-docid tile) — k docs outrank it, contradiction."""
    lv = live_tiles[tsel]
    mask = (scores > 0) & (lv > 0)
    final = jnp.where(mask, scores, jnp.float32(-1.0))  # [B, LANE]
    return _topk_in_tiles_final_q(final, tsel, k)


def _topk_in_tiles_final_q(final, tsel, k):
    """Rank stage over already-masked per-tile score lanes (-1 = no
    match). Same exactness argument as _topk_in_tiles_q."""
    B = tsel.shape[0]
    kt = min(k, B)
    dgrid = tsel[:, None] * LANE + jax.lax.broadcasted_iota(
        jnp.int32, (1, LANE), 1
    )  # [B, LANE]
    tmax = jnp.max(final, axis=1)  # [B]
    _, top_tiles = jax.lax.top_k(tmax, kt)  # ties -> lower docid tile
    cand = final[top_tiles].reshape(-1)
    cand_docs = dgrid[top_tiles].reshape(-1)
    neg, dsort = jax.lax.sort(
        (jnp.negative(cand), cand_docs),
        dimension=0,
        is_stable=True,
        num_keys=2,
    )
    return -neg[:k], dsort[:k]


@partial(jax.jit, static_argnames=("k", "B"))
def row_score_topk_pruned_or(
    heavy_bank,  # f32 [H, D]
    light_bank,  # f32 [L, D] (row 0 all-zero)
    heavy_ub,  # f32 [H, G]
    light_ub,  # f32 [L, G]
    heavy_bits,  # u32 [H, G4]
    light_bits,  # u32 [L, G4]
    live,  # f32 [D]
    live_bits,  # u32 [G4]
    hidx,  # int32 [Q, Tq]
    lidx,  # int32 [Q, Tq]
    *,
    k: int,
    B: int,
):
    """Pruned pure-OR scoring with sum-of-tile-maxima bounds (cheap: one
    [G] row per clause — right for selective queries / small batches).
    Output [Q, 2k+2]: scores, docids, exact hits, 'safe' flag (0 -> the
    executor must escalate that query)."""
    H, D = heavy_bank.shape
    G = D // LANE
    Bk = min(B, G)
    heavy_tiles = heavy_bank.reshape(H * G, LANE)
    light_tiles = light_bank.reshape(-1, LANE)
    live_tiles = live.reshape(G, LANE)
    light_small = light_bank.shape[0] == 1

    def one_query(hidx_q, lidx_q):
        def ub_step(ub, inp):
            hi, li = inp
            ubh = heavy_ub[jnp.maximum(hi, 0)]
            if light_small:
                ubr = jnp.where(hi >= 0, ubh, jnp.float32(0.0))
            else:
                ubr = jnp.where(hi >= 0, ubh, light_ub[jnp.maximum(li, 0)])
            return ub + ubr, None

        ub, _ = jax.lax.scan(
            ub_step, jnp.zeros((G,), jnp.float32), (hidx_q, lidx_q)
        )
        hits = _bitmap_hits_q(
            hidx_q, lidx_q, heavy_bits, light_bits, live_bits, light_small
        )

        if Bk < G:
            ubtop, tfull = jax.lax.top_k(ub, Bk + 1)
            tsel = jnp.sort(tfull[:Bk])  # docid order for the rank stage
            u_next = ubtop[Bk]
        else:
            tsel = jnp.arange(G, dtype=jnp.int32)
            u_next = None

        scores = _rescore_tiles_q(
            hidx_q, lidx_q, tsel, heavy_tiles, light_tiles, G, light_small
        )
        top_scores, top_docs = _topk_in_tiles_q(scores, tsel, live_tiles, k)

        if u_next is None:
            safe = jnp.ones((1,), jnp.float32)
        else:
            theta = top_scores[k - 1]
            safe = ((theta > u_next) | (u_next <= 0)).astype(jnp.float32)[
                None
            ]
        return jnp.concatenate(
            [
                top_scores,
                top_docs.astype(jnp.float32),
                hits[None].astype(jnp.float32),
                safe,
            ]
        )

    return jax.vmap(one_query)(hidx, lidx)


# Relative error bound for the bf16 approx pass: each contribution c >= 0
# is stored as bf16(c) with |bf16(c)-c| <= 2^-9 c, and the matrix product
# accumulates the (exact) bf16 products in f32 in any order, adding at most
# n*2^-24 relative. 2^-7 gives
# a 4x safety factor over the worst case.
_APPROX_RELEPS = np.float32(2.0 ** -7)


@jax.jit
def _take_rows(fused, take):
    """Broadcast deduped fused rows back to batch order (jitted: an
    eager gather costs a host dispatch of its own per call)."""
    return fused[take]


@partial(jax.jit, static_argnums=(3,))
def _merge_split(f1, f2, inv, k):
    """Reassemble a purity-split batch: widen any exhaustive layout
    ([*, 2k+1]) with a safe=1 column, concat, restore original order."""

    def widen(f):
        if f.shape[-1] == 2 * k + 1:  # exhaustive: exact by construction
            return jnp.concatenate(
                [f, jnp.ones((f.shape[0], 1), f.dtype)], axis=1
            )
        return f

    return jnp.concatenate([widen(f1), widen(f2)])[inv]


def _select_tiles(tile_upper, Bk: int, G: int, deterministic: bool = True):
    """Batch tile selection: (tsel int32 [Q, Bk] ascending, u_next [Q],
    min_unsel_feas int32 [Q]).

    Selection is exact ``top_k`` with ties toward the LOWER tile index
    (== lower docid): it has no recall misses (a missed high-UB tile
    would land in u_next and escalate the query), and the boolean tie
    certificate
    (_pruned_batch_finish) relies on docid-ordered selection of
    zero-upper-bound feasible tiles (score-0 matches, e.g. FILTER-only
    queries). ``u_next`` is the EXACT maximum upper bound over the
    unselected tiles (membership-mask + masked max — no scatter, see
    CLAUDE.md): ``theta > u_next`` proves every true top-k doc lives in
    a selected tile. u_next = -inf when every tile is selected.

    ``min_unsel_feas`` is the smallest UNSELECTED tile index whose upper
    bound is >= 0 (G when none): on the boolean path tile_upper >= 0
    marks feasible tiles (infeasible carry -1*(1+eps)), so it bounds the
    lowest docid any unselected match can have."""
    Q = tile_upper.shape[0]
    if Bk >= G:
        tsel = jnp.broadcast_to(
            jnp.arange(G, dtype=jnp.int32)[None], (Q, G)
        )
        return (
            tsel,
            jnp.full((Q,), -jnp.inf, jnp.float32),
            jnp.full((Q,), G, jnp.int32),
        )
    if G >= 4096:
        # EXACT hierarchical top-k: a flat top_k over wide [Q, G] rows
        # is costly, while two stages over 16-tile supertiles stay
        # exact: every true top-Bk tile lives in a top-Bk
        # supertile (its supertile max >= that tile's bound, and Bk
        # supertiles outranking it would each contain a better tile).
        # u_next is exact and scatter-free: an unselected tile is
        # either in an unselected supertile (bound <= (Bk+1)-th
        # supertile max, itself an unselected tile's bound) or an
        # unselected member of a gathered supertile (<= (Bk+1)-th
        # gathered value).
        #
        # Boolean (deterministic) path: sorting the selected supertiles
        # ascending BEFORE the gather puts stage-2 candidates in docid
        # order, so top_k's lower-index tie break prefers lower docids
        # — the zero-bound tie behavior the (c) certificate in
        # _pruned_batch_finish wants. A cross-supertile zero tie CAN
        # still pick a higher-docid zero tile than the flat kernel
        # (when a 0-max supertile is dropped for a positive-max one
        # holding later zeros); min_unsel then exposes the dropped
        # lower-docid feasible tile and the query escalates — exactness
        # is never at stake, only that query's latency.
        SUP = 16
        Gp = -(-G // SUP) * SUP
        tu = tile_upper
        if Gp != G:
            tu = jnp.pad(
                tile_upper, ((0, 0), (0, Gp - G)),
                constant_values=-jnp.inf,
            )
        Gs = Gp // SUP
        if Gs > Bk:
            tu3 = tu.reshape(Q, Gs, SUP)
            sup = tu3.max(axis=2)
            sv, sidx = jax.lax.top_k(sup, Bk + 1)
            ssel = sidx[:, :Bk]
            if deterministic:
                ssel = jnp.sort(ssel, axis=1)
            cand = jnp.take_along_axis(
                tu3, ssel[:, :, None], axis=1
            ).reshape(Q, Bk * SUP)
            cv, cidx2 = jax.lax.top_k(cand, Bk + 1)
            csel = cidx2[:, :Bk]
            gsel = (
                jnp.take_along_axis(ssel, csel // SUP, axis=1) * SUP
                + csel % SUP
            )
            tsel = jnp.sort(gsel.astype(jnp.int32), axis=1)
            u_next = jnp.maximum(sv[:, Bk], cv[:, Bk])
            if not deterministic:
                return tsel, u_next, jnp.full((Q,), G, jnp.int32)
            # min unselected FEASIBLE tile (bound >= 0), exact for THIS
            # selection, from two small [Q, Bk]-sized scatters instead
            # of the [Q, G] masked scan:
            qr = jnp.arange(Q, dtype=jnp.int32)[:, None]
            # (a) unselected candidates inside gathered supertiles
            cpos = jax.lax.broadcasted_iota(jnp.int32, cand.shape, 1)
            cglob = (
                jnp.take_along_axis(ssel, cpos // SUP, axis=1) * SUP
                + cpos % SUP
            )
            unsel_c = (
                jnp.ones(cand.shape, jnp.bool_).at[qr, csel].set(False)
            )
            in_g = jnp.min(
                jnp.where((cand >= 0) & unsel_c, cglob, jnp.int32(G)),
                axis=1,
            )
            # (b) unselected supertiles: their first feasible member
            off = jnp.where(
                tu3 >= 0,
                jax.lax.broadcasted_iota(jnp.int32, tu3.shape, 2),
                jnp.int32(SUP),
            )
            f_off = jnp.min(off, axis=2)  # [Q, Gs]
            sbase = (
                jax.lax.broadcasted_iota(jnp.int32, sup.shape, 1) * SUP
            )
            feas_tile = jnp.where(
                f_off < SUP, sbase + f_off, jnp.int32(G)
            )
            feas_tile = feas_tile.at[qr, ssel].set(jnp.int32(G))
            out_g = jnp.min(feas_tile, axis=1)
            min_unsel_feas = jnp.minimum(jnp.minimum(in_g, out_g), G)
            return tsel, u_next, min_unsel_feas
    return _select_tiles_flat(tile_upper, Bk, G)


def _select_tiles_flat(tile_upper, Bk: int, G: int):
    """Flat single-stage selection (reference semantics; small G)."""
    Q = tile_upper.shape[0]
    # exact top_k: deterministic ties (-> lower tile index) and no
    # recall-miss escalations
    _, idx = jax.lax.top_k(tile_upper, Bk)
    tsel = jnp.sort(idx.astype(jnp.int32), axis=1)  # docid-order rank stage
    # mask the selected tiles out with a Q*Bk-element scatter (tiny;
    # a [Q, Bk, G] membership broadcast materialized 2.5 GB at 10M docs)
    masked = tile_upper.at[
        jnp.arange(Q, dtype=jnp.int32)[:, None], tsel
    ].set(-jnp.inf)
    u_next = jnp.max(masked, axis=1)
    gidx = jax.lax.broadcasted_iota(jnp.int32, masked.shape, 1)
    min_unsel_feas = jnp.min(
        jnp.where(masked >= 0, gidx, jnp.int32(G)), axis=1
    )
    return tsel, u_next, min_unsel_feas


@partial(jax.jit, static_argnames=("Bk", "boolean"))
def _pruned_batch_phase1(
    compact_bf16, a_sc_t, a_rq_t, a_sh_t, a_ng_t,
    params_t, live, *, Bk: int, boolean: bool, a_cb_t=None,
):
    """Phase 1 + tile selection as its own program, so the staged
    pipeline can cache it (p1_cache) and huge segments never hold the
    phase-1 and phase-2 temporaries at once; the boundary is a tiny
    [Q, Bk] selection."""
    from diagon_tpu.ops.approx import approx_select

    G = compact_bf16.shape[1] // LANE
    if boolean and a_cb_t is not None:
        roles = (a_cb_t,)
    elif boolean:
        roles = (a_rq_t, a_sh_t, a_ng_t)
    else:
        roles = ()
    tmax, hits = approx_select(compact_bf16, live, a_sc_t, roles, params_t)
    tile_upper = tmax * (jnp.float32(1.0) + _APPROX_RELEPS)  # [Q, G]
    tsel, u_next, min_unsel = _select_tiles(
        tile_upper, Bk, G, deterministic=boolean
    )
    return tsel, u_next, min_unsel, hits


@partial(jax.jit, static_argnames=("k", "boolean"))
def _pruned_batch_phase2(
    compact_t, cidx, cflags, live, tsel, u_next, min_unsel, hits,
    bool_params, *, k: int, boolean: bool,
):
    G = compact_t.shape[0]
    live_tiles = live.reshape(G, LANE)
    if boolean:
        scores, rc, oc, nc = rescore_compact(compact_t, cidx, tsel, cflags)
    else:
        scores = rescore_compact(compact_t, cidx, tsel)  # [Q, Bk, LANE]
        rc = oc = nc = None
    return _pruned_batch_finish(
        scores, rc, oc, nc, bool_params, tsel, u_next, min_unsel,
        hits, live_tiles, k=k, boolean=boolean,
    )


@partial(jax.jit, static_argnames=("k", "Bk", "out_q", "boolean"))
def _pruned_batch_fused(
    compact_t, compact_bf16, cidx, cflags, live,
    a_sc_t, a_rq_t, a_sh_t, a_ng_t, params_t, bool_params, a_cb_t,
    *, k: int, Bk: int, out_q: int, boolean: bool,
):
    """phase1 + phase2 + pad-slice as ONE program: below
    batch_only_min_docs the staged two-call pipeline only costs two
    extra host dispatches per batch."""
    tsel, u_next, min_unsel, hits = _pruned_batch_phase1(
        compact_bf16, a_sc_t, a_rq_t, a_sh_t, a_ng_t,
        params_t, live, Bk=Bk, boolean=boolean, a_cb_t=a_cb_t,
    )
    fused = _pruned_batch_phase2(
        compact_t, cidx, cflags, live, tsel, u_next, min_unsel, hits,
        bool_params, k=k, boolean=boolean,
    )
    return fused[:out_q]


def row_score_topk_pruned_batch(
    compact_t,  # f32 [G, U8, LANE] batch-compact tile-major bank (exact)
    compact_bf16,  # bf16 [U8, D] approx copy (phase-1 matmul)
    cidx,  # int32 [Q, Tq] compact row per clause (0 = zero row)
    cflags,  # int32 [Q, Tq] bit0 scoring / 1 req / 2 sho / 3 neg
    live,  # f32 [D]
    a_sc_t,  # bf16 [U8, Q] scoring-clause indicator (transposed)
    a_rq_t,  # bf16 [U8, Q]
    a_sh_t,  # bf16 [U8, Q]
    a_ng_t,  # bf16 [U8, Q]
    params_t,  # f32 [8, Q] rows 0=num_required, 1=min_should
    bool_params,  # f32 [Q, 2]
    *,
    k: int,
    B: int,
    boolean: bool,
    a_cb_t=None,
    staged: bool = True,
    out_q: int = None,
    p1_cache: dict = None,
):
    """Matmul-selected pruned scoring for query BATCHES (the WANDScorer /
    MaxScoreBulkScorer role, WANDScorer.h:17-285, MaxScoreBulkScorer.h).

    Everything runs against the BATCH-COMPACT bank (the union of clause
    rows this batch uses), so both phases scale with the batch's
    vocabulary, not the corpus's heavy-term count:

    - Phase 1 (ops/approx.py): one bf16 matmul of the query-indicator
      matrix against the compact bank computes an approximate score for
      EVERY doc — the bank is read once per batch instead of once per
      (query, clause). Contributions are nonnegative, so approx > 0 iff
      some clause matches, making the live-masked positive count the
      EXACT hit count. For general booleans, 0/1 presence-indicator
      matmuls (presence derived from the score bank) give EXACT clause
      counts (sums of <= Tq ones are exact in f32) and the match mask /
      hit counts equal the oracle's; candidate tiles are additionally
      gated on per-tile feasibility.
    - true_score <= approx * (1 + 2^-7) (relative bf16+accum bound), so
      tile selection by that upper bound is provably exact; ties within
      the margin fail the certificate and escalate.
    - Phase 2 (rescore_compact): the selected tiles rescore from the
      exact f32 compact bank in oracle clause order — bit-exact scores
      and counts.
    """
    G, U8, _ = compact_t.shape
    Bk = min(B, G)
    Q = cidx.shape[0]
    if out_q is None:
        out_q = Q
    # p1 replay (the LRUQueryCache role) rides the STAGED pipeline only:
    # below the huge-segment threshold the fused single program wins on
    # dispatch count and phase 1 is cheap, so small segments keep the
    # fused path and simply don't populate the cache
    if not staged:
        return _pruned_batch_fused(
            compact_t, compact_bf16, cidx, cflags, live,
            a_sc_t, a_rq_t, a_sh_t, a_ng_t, params_t, bool_params,
            a_cb_t, k=k, Bk=Bk, out_q=out_q, boolean=boolean,
        )
    p1 = p1_cache.get(Bk) if p1_cache is not None else None
    if p1 is None:
        p1 = _pruned_batch_phase1(
            compact_bf16, a_sc_t, a_rq_t, a_sh_t, a_ng_t,
            params_t, live, Bk=Bk, boolean=boolean, a_cb_t=a_cb_t,
        )
        if p1_cache is not None:
            p1_cache[Bk] = p1
    tsel, u_next, min_unsel, hits = p1
    fused = _pruned_batch_phase2(
        compact_t, cidx, cflags, live, tsel, u_next, min_unsel, hits,
        bool_params, k=k, boolean=boolean,
    )
    return fused if out_q == Q else fused[:out_q]


def _pruned_batch_finish(
    scores, rc, oc, nc, bool_params, tsel, u_next, min_unsel, hits,
    live_tiles, *, k: int, boolean: bool,
):
    if boolean:

        def finish(scores_q, rc_q, oc_q, nc_q, params_q, tsel_q, u_next_q,
                   min_unsel_q):
            lv = live_tiles[tsel_q]
            mask = (
                (rc_q == params_q[0])
                & (oc_q >= params_q[1])
                & (nc_q == 0)
                & ((rc_q + oc_q) > 0)
                & (lv > 0)
            )
            final = jnp.where(mask, scores_q, jnp.float32(-1.0))
            top_scores, top_docs = _topk_in_tiles_final_q(
                final, tsel_q, k
            )
            theta = top_scores[k - 1]
            # Boolean certificate. Unlike pure-OR, a boolean match may
            # carry score 0 (FILTER-only / non-scoring clauses), so an
            # unselected FEASIBLE tile with upper bound 0 can still hold
            # true top-k docs — u_next <= 0 proves nothing here. Safe iff:
            #  (a) theta > u_next: strict dominance (any unselected match
            #      scores <= u_next < theta);
            #  (b) u_next < 0: every unselected tile is infeasible
            #      (feasible tiles carry upper bound >= 0, infeasible
            #      -1*(1+eps)), so no unselected matches exist at all; or
            #  (c) the zero-tie case: theta == 0, u_next == 0, and the
            #      k-th candidate's tile precedes every unselected
            #      feasible tile. All unselected matches then score
            #      exactly 0 with docids >= min_unsel*128 > docid_k, so
            #      (score desc, docid asc) ranks them below the k-th
            #      candidate — and below every shallower zero-score
            #      candidate too (those have docid < docid_k by the sort).
            #      Deterministic lower-index tile selection
            #      (_select_tiles deterministic=True) makes this the
            #      common outcome for score-0 queries instead of a
            #      certificate failure.
            tile_k = top_docs[k - 1] // LANE
            safe = (
                (theta > u_next_q)
                | (u_next_q < 0)
                | (
                    (theta == 0)
                    & (u_next_q == 0)
                    & (tile_k < min_unsel_q)
                )
            ).astype(jnp.float32)[None]
            return jnp.concatenate(
                [top_scores, top_docs.astype(jnp.float32), safe]
            )

        fused = jax.vmap(finish)(
            scores, rc, oc, nc, bool_params, tsel, u_next, min_unsel
        )
    else:

        def finish(scores_q, tsel_q, u_next_q):
            top_scores, top_docs = _topk_in_tiles_q(
                scores_q, tsel_q, live_tiles, k
            )
            theta = top_scores[k - 1]
            # u_next <= 0 means the unselected tiles are empty (approx
            # of nonnegative contributions): safe. u_next = -inf when
            # every tile was selected.
            safe = (
                (theta > u_next_q) | (u_next_q <= 0)
            ).astype(jnp.float32)[None]
            return jnp.concatenate(
                [top_scores, top_docs.astype(jnp.float32), safe]
            )

        fused = jax.vmap(finish)(scores, tsel, u_next)  # [Q, 2k+1]
    return jnp.concatenate(
        [
            fused[:, : 2 * k],
            hits[:, None].astype(jnp.float32),
            fused[:, 2 * k :],
        ],
        axis=1,
    )


def _decode_term_numpy(pp, tid: int):
    """Vectorized host decode of ALL of one term's posting blocks ->
    (docids i32 asc, freqs i32). Same per-element arithmetic as the
    scalar ``decode_block_numpy`` oracle (verified bit-equal by the
    parity suites), ~30x faster for multi-block terms because every
    block decodes in one 2-D numpy pass."""
    b0, b1 = int(pp.block_start[tid]), int(pp.block_start[tid + 1])
    nb = b1 - b0
    if nb == 0:
        return (np.zeros(0, np.int32), np.zeros(0, np.int32))
    packed = pp.packed
    lane = np.arange(LANE, dtype=np.int64)[None, :]
    dbits = pp.block_doc_bits[b0:b1].astype(np.int64)[:, None]
    fbits = pp.block_freq_bits[b0:b1].astype(np.int64)[:, None]
    woff = pp.block_word_off[b0:b1].astype(np.int64)[:, None]
    count = pp.block_count[b0:b1].astype(np.int64)
    base = pp.block_base[b0:b1].astype(np.int64)
    last = len(packed) - 1

    def extract(bits, base_word):
        bitpos = lane * bits
        widx = base_word + (bitpos >> 5)
        shift = (bitpos & 31).astype(np.uint64)
        lo = packed[np.minimum(widx, last)].astype(np.uint64)
        hi = packed[np.minimum(widx + 1, last)].astype(np.uint64)
        val = (lo | (hi << np.uint64(32))) >> shift
        mask = (np.uint64(1) << bits.astype(np.uint64)) - np.uint64(1)
        return (val & mask).astype(np.int64)

    deltas = extract(dbits, woff)
    dwords = (count[:, None] * dbits + 31) >> 5
    freqs = extract(fbits, woff + dwords)
    freqs = np.where(fbits == 0, np.int64(1), freqs)
    docs = base[:, None] + np.cumsum(deltas, axis=1)
    valid = lane < count[:, None]
    return (
        docs[valid].astype(np.int32),
        freqs[valid].astype(np.int32),
    )


@partial(jax.jit, static_argnames=("F",), donate_argnums=(0,))
def _build_bank_chunk(
    bank,  # f32 [H+1, D] carried bank (row H = dump row), donated
    packed,  # u32 [W] shared word stream
    woff,  # i32 [NBc] word offset of each selected block
    dbits,  # i32 [NBc]
    fbits,  # i32 [NBc]
    base,  # i32 [NBc] first docid
    count,  # i32 [NBc] (0 = padding block -> dump row)
    rowid,  # i32 [NBc] target bank row of each block's term
    idf,  # f32 [NBc] per-block term idf (the row scale)
    norms,  # i32 [D]
    lut,  # f32 [128*F] host-precomputed tf table
    *,
    F: int,
):
    """Decode one CHUNK of selected posting blocks into the carried dense
    bank — entirely on device (10^8-posting numpy decodes take minutes on
    one host core). Chunking bounds the scatter's index temporaries: an
    unchunked build at 10M docs (~4M heavy blocks) asks XLA for a
    >16 GB scatter temp.

    Bit-exactness: the LUT values are the host table verbatim and the one
    f32 multiply (idf * tf) is IEEE round-to-nearest — identical to the
    numpy scalar product the oracle computes. The scatter is .set with
    unique (row, doc) targets, so no accumulation-order concerns.
    """
    H1 = bank.shape[0]
    NBh = woff.shape[0]
    lane = jax.lax.broadcasted_iota(jnp.int32, (NBh, LANE), 1)

    def extract(bits, base_word):
        bitpos = lane * bits[:, None]
        widx = base_word[:, None] + (bitpos >> 5)
        shift = (bitpos & 31).astype(jnp.uint32)
        lo = packed[widx] >> shift
        hi = jnp.where(
            shift == 0,
            jnp.uint32(0),
            packed[widx + 1] << (jnp.uint32(32) - shift),
        )
        mask = (
            jnp.uint32(1) << bits[:, None].astype(jnp.uint32)
        ) - jnp.uint32(1)
        return ((lo | hi) & mask).astype(jnp.int32)

    deltas = extract(dbits, woff)
    dwords = (count * dbits + 31) >> 5
    freqs = extract(fbits, woff + dwords)
    # fbits == 0 encodes an all-freq-1 block (no freq section)
    freqs = jnp.where(fbits[:, None] == 0, jnp.int32(1), freqs)
    docs = base[:, None] + jnp.cumsum(deltas, axis=1)
    valid = lane < count[:, None]
    docs = jnp.where(valid, docs, 0)
    tf = lut[norms[docs] * F + jnp.clip(freqs, 0, F - 1)]
    vals = idf[:, None] * tf
    r = jnp.where(valid, rowid[:, None], H1 - 1)  # invalid -> dump row
    D = bank.shape[1]
    # 1-D flat scatter over a flat [NBc*128] i32 index (a 2-D [NBc, 128,
    # 2] index tensor is larger and can be padded by the backend's
    # layout). Callers guarantee H1 * D < 2^31 by building in row groups.
    assert H1 * D < 2**31, "bank group too large for flat i32 scatter"
    flat = bank.reshape(H1 * D)
    flat = flat.at[(r * D + docs).reshape(-1)].set(vals.reshape(-1))
    return flat.reshape(H1, D)


@partial(jax.jit, donate_argnums=(0,))
def _set_bank_row(bank, row, r):
    """Donated single-row write (host-materialized light rows)."""
    return jax.lax.dynamic_update_slice(bank, row[None], (r, 0))


@partial(jax.jit, donate_argnums=(0, 1))
def _place_rows(final, sub, g0):
    """Donated row-group write into the full bank (drops sub's trailing
    dump row inside the jit so no host-side slice copy materializes)."""
    return jax.lax.dynamic_update_slice(final, sub[:-1], (g0, 0))


@partial(jax.jit, donate_argnums=(0, 1))
def _compact_place(ct, cb, sub, g0):
    """Donated write of one scatter-built row group (sub [rows+1, D],
    trailing dump row dropped in-jit) into the on-demand compact banks:
    bf16 row-major for phase 1, tile-major f32 for phase 2. Donation
    keeps the 10-GB-scale banks in place across groups."""
    rows = sub.shape[0] - 1
    body = sub[:-1]
    cb = jax.lax.dynamic_update_slice(
        cb, body.astype(jnp.bfloat16), (g0, jnp.int32(0))
    )
    G = ct.shape[0]
    sub_t = body.reshape(rows, G, LANE).transpose(1, 0, 2)
    ct = jax.lax.dynamic_update_slice(
        ct, sub_t, (jnp.int32(0), g0, jnp.int32(0))
    )
    return ct, cb


@partial(jax.jit, donate_argnums=(0, 1))
def _compact_place_row(ct, cb, row, g0):
    """Donated single-row write into the on-demand compact banks (light
    rows appended after the heavy groups; row [1, D] f32)."""
    cb = jax.lax.dynamic_update_slice(
        cb, row.astype(jnp.bfloat16), (g0, jnp.int32(0))
    )
    G = ct.shape[0]
    row_t = row.reshape(1, G, LANE).transpose(1, 0, 2)
    ct = jax.lax.dynamic_update_slice(
        ct, row_t, (jnp.int32(0), g0, jnp.int32(0))
    )
    return ct, cb


@partial(jax.jit, static_argnames=("u8", "lb"))
def _assemble_compact(heavy_bank, used_idx, used_mask, light_bank,
                      light_mask, n_used, *, u8: int, lb: int):
    """Resident-mode compact bank [u8, D] in one shape-bucketed program:
    row 0 zero, rows 1..n_used = heavy_bank[used], then the light rows,
    zeros beyond. used_idx/used_mask are padded to a 32-row bucket (mask
    zeroes the padding gathers) and the light block to an 8-row bucket,
    so novel serving batches with drifting vocabulary sizes reuse ONE
    compiled assembly instead of recompiling gather+concat per batch."""
    D = heavy_bank.shape[1]
    rows = jnp.zeros((u8, D), jnp.float32)
    hb = heavy_bank[used_idx] * used_mask[:, None]
    rows = jax.lax.dynamic_update_slice(rows, hb, (jnp.int32(1), 0))
    nl = light_bank.shape[0] - 1
    if nl < lb:
        light_bank = jnp.pad(light_bank, ((0, lb - nl), (0, 0)))
    lrows = light_bank[1 : 1 + lb] * light_mask[:, None]
    # placed AFTER the heavy block: overwrites its masked padding rows
    return jax.lax.dynamic_update_slice(
        rows, lrows, (jnp.int32(1) + n_used, 0)
    )


@partial(jax.jit, donate_argnums=(0,))
def _compact_place_t(ct, sub, g0):
    """Tile-major-only variant of _compact_place: phase-0 entries hold
    no bf16 bank (selection rides tile maxima, hits ride bitmaps)."""
    body = sub[:-1]
    rows = body.shape[0]
    G = ct.shape[0]
    sub_t = body.reshape(rows, G, LANE).transpose(1, 0, 2)
    return jax.lax.dynamic_update_slice(
        ct, sub_t, (jnp.int32(0), g0, jnp.int32(0))
    )


@partial(jax.jit, donate_argnums=(0,))
def _compact_place_row_t(ct, row, g0):
    G = ct.shape[0]
    row_t = row.reshape(1, G, LANE).transpose(1, 0, 2)
    return jax.lax.dynamic_update_slice(
        ct, row_t, (jnp.int32(0), g0, jnp.int32(0))
    )


@jax.jit
def _ubank_from_tiles(ct):
    """[G, U8, LANE] -> [U8, G] per-row tile maxima (one bank read)."""
    return ct.max(axis=2).T


@partial(jax.jit, static_argnames=("rows",), donate_argnums=(0,))
def _bits_place_chunk(bits, ct, live_tiles, g0, *, rows):
    """Pack (row > 0) & live presence bits for a tile-chunk into the
    [U8, G*4] u32 bitmap bank. Bit d%32 of word d//32 covers doc d
    (d = g*LANE + l -> word g*4 + l//32), matching _pack_live_bits."""
    sl = jax.lax.dynamic_slice_in_dim(ct, g0, rows, 0)  # [rows, U8, LANE]
    lv = jax.lax.dynamic_slice_in_dim(live_tiles, g0, rows, 0)
    m = ((sl > 0) & (lv[:, None, :] > 0)).astype(jnp.uint32)
    m4 = m.reshape(rows, sl.shape[1], 4, 32)
    w = jnp.sum(
        m4 << jax.lax.broadcasted_iota(jnp.uint32, m4.shape, 3),
        axis=-1, dtype=jnp.uint32,
    )  # [rows, U8, 4]
    wt = w.transpose(1, 0, 2).reshape(sl.shape[1], rows * 4)
    return jax.lax.dynamic_update_slice(
        bits, wt, (jnp.int32(0), g0 * jnp.int32(4))
    )


def _build_bits_bank(ct, live, device=None):
    """u32 [U8, G*4] live presence bitmaps from the tile-major bank,
    chunked so the u32 unpack temp stays ~256 MB at any scale."""
    G, U8, _ = ct.shape
    live_tiles = live.reshape(G, LANE)
    bits = jnp.zeros((U8, G * 4), jnp.uint32)
    if device is not None:
        bits = jax.device_put(bits, device)
    step = max(256, (1 << 26) // max(U8 * LANE, 1))
    # round the step so only two distinct (rows, U8) compiles exist
    step = min(G, -(-step // 256) * 256)
    for g0 in range(0, G, step):
        rows = min(step, G - g0)
        bits = _bits_place_chunk(
            bits, ct, live_tiles, jnp.int32(g0), rows=rows
        )
    return bits


@partial(jax.jit, static_argnames=("Bk", "boolean"))
def _pruned_batch_phase0(ubank, a_sc_f, a_rq_f, a_sh_f, params_t,
                         *, Bk: int, boolean: bool):
    """Tile selection from per-row TILE maxima (no per-doc pass).

    tile_upper[q, g] = sum over q's scoring clauses of row tile maxima
    >= the true max score in tile g (true scores are f32 sums of the
    same row values; the (1 + _APPROX_RELEPS) inflation dominates both
    the f32 matmul's reassociation rounding and the oracle's summation
    order). Boolean tiles are additionally feasibility-gated: a tile
    missing any required row, or with fewer present SHOULD rows than
    min_should, can hold no match and gets bound -1*(1+eps) — exactly
    the phase-1 infeasible marker, so downstream certificates
    (_pruned_batch_finish) are unchanged. Selection looseness only ever
    costs an escalation, never exactness: any unselected doc's true
    score <= its tile bound <= u_next, and the certificate demands
    theta > u_next (or the zero/infeasible cases) before trusting the
    pruned result."""
    G = ubank.shape[1]
    # f32 operands: HIGHEST keeps the product out of reduced-precision
    # (TF32) tensor-core modes, which the bound below does not cover
    ct = lambda a, b: jax.lax.dot_general(
        a, b, dimension_numbers=(((0,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    ub0 = ct(a_sc_f, ubank)  # [Q, G]
    m = jnp.float32(1.0) + _APPROX_RELEPS
    if boolean:
        pres = (ubank > 0).astype(jnp.float32)
        rc = ct(a_rq_f, pres)
        oc = ct(a_sh_f, pres)
        nreq = params_t[0][:, None]
        msm = params_t[1][:, None]
        feasible = (rc >= nreq) & (oc >= msm)
        tile_upper = jnp.where(feasible, ub0 * m, jnp.float32(-1.0) * m)
    else:
        tile_upper = ub0 * m
    return _select_tiles(tile_upper, Bk, G, deterministic=boolean)


# blocks per _build_bank_chunk call. 2^16 bounds the chunk program's
# scoped decode temps to ~0.7 GB: the 2^18 version's ~3 GB of temps
# OOM'd the 10M-doc build next to its 6.5 GB bank.
_BANK_BUILD_CHUNK = 1 << 16
# flat scatter index limit (i32); patchable in tests to force the
# row-grouped build path on small corpora
_FLAT_SCATTER_MAX = 2**31


def _scatter_bank_rows(bank, meta, packed_dev, norms_dev, lut_dev, F,
                       device=None):
    """Chunked flat-scatter of decoded posting blocks into ``bank``
    ([rows+1, D], last row = scatter dump). meta arrays are per-block:
    woff/dbits/fbits/base/count/rowid/idf (idf = the row scale — the
    collection idf for heavy banks, the clause weight for device-built
    light rows; one IEEE multiply either way, bit-equal to host_row)."""
    import jax as _jax

    def dev(x):
        return _jax.device_put(jnp.asarray(x), device)

    nbg = len(meta["woff"])
    CH = _BANK_BUILD_CHUNK
    n_chunks = max(1, -(-nbg // CH))
    if nbg > CH:
        npad = n_chunks * CH - nbg
    else:
        # pad sub-chunk builds to a power-of-two bucket (floor 4096):
        # every DISTINCT block count otherwise compiles its own
        # _build_bank_chunk kernel, and the 10M on-demand build's
        # per-row-group counts are all distinct — dozens of multi-second
        # compiles per cold batch. Buckets cap that at 5 shapes.
        bucket = min(CH, max(4096, 1 << max(0, nbg - 1).bit_length()))
        npad = bucket - nbg
    if npad:
        meta = {
            kk: np.concatenate([v, np.zeros(npad, dtype=v.dtype)])
            for kk, v in meta.items()
        }
    for ci in range(n_chunks):
        sl = slice(ci * CH, ci * CH + min(CH, len(meta["woff"])))
        bank = _build_bank_chunk(
            bank,
            packed_dev,
            dev(meta["woff"][sl]),
            dev(meta["dbits"][sl]),
            dev(meta["fbits"][sl]),
            dev(meta["base"][sl]),
            dev(meta["count"][sl]),
            dev(meta["rowid"][sl]),
            dev(meta["idf"][sl]),
            norms_dev,
            lut_dev,
            F=F,
        )
    return bank


def _block_meta(pp, bsel, rowid, scale):
    return {
        "woff": pp.block_word_off[bsel].astype(np.int32),
        "dbits": pp.block_doc_bits[bsel].astype(np.int32),
        "fbits": pp.block_freq_bits[bsel].astype(np.int32),
        "base": pp.block_base[bsel].astype(np.int32),
        "count": pp.block_count[bsel].astype(np.int32),
        "rowid": rowid.astype(np.int32),
        "idf": scale.astype(np.float32),
    }


class RowFieldIndex:
    """Host+device state to produce per-term dense score rows."""

    def __init__(
        self,
        pp,  # PackedPostings (host)
        norms: np.ndarray,
        num_docs_pad: int,
        live_docs: Optional[np.ndarray],
        tf_lut_host: np.ndarray,  # unscaled [128*F] f32 (idf=1)
        device=None,
    ):
        self.pp = pp
        self.num_docs_pad = num_docs_pad
        self.tf_lut_host = np.asarray(tf_lut_host, np.float32)
        self.F = len(self.tf_lut_host) // 128
        self.norms = norms.astype(np.int64)

        live = np.zeros(num_docs_pad, dtype=np.float32)
        n_real = len(norms)
        if live_docs is None:
            live[:n_real] = 1.0
        else:
            live[: len(live_docs)] = live_docs.astype(np.float32)
        self.live = jax.device_put(jnp.asarray(live), device)
        self.device = device

        # pruning needs doc-pad divisible into 128-doc tiles / 32-bit words
        self.prunable = num_docs_pad % LANE == 0
        self.live_bits = _pack_live_bits(self.live) if self.prunable else None

        # heavy-term device bank (rows scaled by each term's own idf at
        # searcher-provided weights; built lazily because idf needs
        # collection stats) — filled by build_heavy_bank.
        self.heavy_row_of_term: Optional[np.ndarray] = None
        self.heavy_bank = None
        self.heavy_ub = None
        self.heavy_bits = None
        # on-demand mode (huge segments): no resident bank; per-row term
        # ids + idf weights let executors scatter-build exactly the rows
        # a batch uses (build_rows_grouped)
        self.bank_on_demand = False
        self.heavy_tid_of_row: Optional[np.ndarray] = None
        self.heavy_weight: Optional[np.ndarray] = None

    # device bytes the dense heavy bank may occupy (top-df rows win)
    BANK_BUDGET_BYTES = 6 << 30
    # segments at least this large skip the resident bank entirely
    ON_DEMAND_MIN_DOCS = BANK_ON_DEMAND_MIN_DOCS

    def device_decode_state(self):
        """(packed, norms, lut) device copies for on-device bank builds,
        uploaded once and shared by the heavy-bank build and per-batch
        light-row builds."""
        st = getattr(self, "_decode_state", None)
        if st is None:
            dev = lambda x: jax.device_put(jnp.asarray(x), self.device)
            norms32 = np.zeros(self.num_docs_pad, dtype=np.int32)
            norms32[: len(self.norms)] = self.norms
            st = (
                dev(self.pp.packed.view(np.uint32)),
                dev(norms32),
                dev(self.tf_lut_host),
            )
            self._decode_state = st
        return st

    def host_row(self, tid: int, weight: np.float32) -> np.ndarray:
        """Dense f32 score row for one term: weight * tf_factor scattered
        onto the doc axis (vectorized numpy block decode — exact oracle
        arithmetic; used for light/boosted clauses). The per-block Python
        loop this replaces was the sparse-serving wall (~40k block
        decodes per 32-query batch)."""
        row = np.zeros(self.num_docs_pad, dtype=np.float32)
        docs, freqs = _decode_term_numpy(self.pp, tid)
        if len(docs):
            row[docs] = np.float32(weight) * self.tf_lut_host[
                self.norms[docs] * self.F + np.minimum(freqs, self.F - 1)
            ]
        return row

    def build_heavy_bank(self, idf_of_tid, heavy_tids=None) -> None:
        """Materialize device rows for frequent terms (decode + scatter run
        on device, _build_bank_device).

        idf_of_tid: callable tid -> np.float32 collection-level idf.
        heavy_tids: optional explicit term-id list (sharded searchers pass
        a globally-aligned heavy set so bank rows line up across shards).
        """
        pp = self.pp
        T = pp.num_terms
        df = pp.doc_freq
        # sharded searchers (explicit heavy_tids) read the materialized
        # bank directly for their in-shard kernels — never on-demand
        self.bank_on_demand = (
            self.prunable
            and heavy_tids is None
            and self.num_docs_pad >= self.ON_DEMAND_MIN_DOCS
        )
        if heavy_tids is not None:
            heavy = np.asarray(heavy_tids, dtype=np.int64)
        else:
            threshold = max(
                HEAVY_MIN_DF, self.num_docs_pad // HEAVY_FRACTION
            )
            heavy = np.nonzero(df >= threshold)[0]
            # HBM budget: the dense bank is 4*D bytes/row — at 10M docs
            # the df>=D/16 set alone is ~209 rows = 8.4 GB. Keep the
            # top-df rows under the budget; overflow terms stay on the
            # (correct, slower) light-row path. On-demand mode holds no
            # resident bank, so no cap applies there.
            max_rows = max(
                1, int(self.BANK_BUDGET_BYTES // (4 * self.num_docs_pad))
            )
            if not self.bank_on_demand and len(heavy) > max_rows:
                order = np.argsort(df[heavy], kind="stable")[::-1]
                heavy = np.sort(heavy[order[:max_rows]])
        self.heavy_row_of_term = np.full(T, -1, dtype=np.int32)
        self.heavy_tid_of_row = heavy.astype(np.int64)
        self.heavy_weight = np.asarray(
            [idf_of_tid(int(t)) if t >= 0 else 0.0 for t in heavy],
            dtype=np.float32,
        )
        present = heavy >= 0  # -1 = globally-heavy term absent here
        if self.bank_on_demand:
            if present.any():
                self.heavy_row_of_term[heavy[present]] = np.nonzero(
                    present
                )[0].astype(np.int32)
            self.heavy_bank = None
            self.heavy_ub = None
            self.heavy_bits = None
            return
        if len(heavy) == 0 or not present.any():
            self.heavy_bank = jax.device_put(
                jnp.zeros((max(1, len(heavy)), self.num_docs_pad),
                          jnp.float32),
                self.device,
            )
        else:
            self.heavy_row_of_term[heavy[present]] = np.nonzero(present)[
                0
            ].astype(np.int32)
            # per-block metadata for every heavy term's blocks
            bsel = np.concatenate(
                [
                    np.arange(
                        int(pp.block_start[t]), int(pp.block_start[t + 1])
                    )
                    for t in heavy[present]
                ]
            )
            rowid = self.heavy_row_of_term[pp.block_term[bsel]]
            idf = self.heavy_weight[rowid]
            H = len(heavy)
            D = self.num_docs_pad
            packed_dev, norms_dev, lut_dev = self.device_decode_state()
            meta = _block_meta(pp, bsel, rowid, idf)

            def build_group(rows, meta_g):
                """[rows+1, D] sub-bank (last row = dump) via chunked
                flat scatters; rows+1 rows keep the flat i32 index
                < 2^31."""
                bank = jnp.zeros((rows + 1, D), jnp.float32)
                if self.device is not None:
                    bank = jax.device_put(bank, self.device)
                return _scatter_bank_rows(
                    bank, meta_g, packed_dev, norms_dev, lut_dev,
                    self.F, self.device,
                )

            if (H + 1) * D < _FLAT_SCATTER_MAX:
                # keep the trailing dump row: bank[:H] would materialize
                # a bank-sized copy at enqueue time (13 GB transient at
                # 10M docs). Row H holds scatter junk; no hidx ever
                # references it and padded/live masks exclude its docs.
                self.heavy_bank = build_group(H, meta)
            else:
                # row-grouped build: sub-banks small enough for the flat
                # scatter, placed into the full bank with donated
                # dynamic_update_slice (rowid is sorted, so each group's
                # blocks are one contiguous slice)
                ROWG = max(1, min(64, (_FLAT_SCATTER_MAX // D) - 1))
                final = jnp.zeros((H, D), jnp.float32)
                if self.device is not None:
                    final = jax.device_put(final, self.device)
                rid = meta["rowid"]
                for g0 in range(0, H, ROWG):
                    rows = min(ROWG, H - g0)
                    lo = int(np.searchsorted(rid, g0))
                    hi = int(np.searchsorted(rid, g0 + rows))
                    meta_g = {
                        kk: v[lo:hi].copy() for kk, v in meta.items()
                    }
                    meta_g["rowid"] = meta_g["rowid"] - np.int32(g0)
                    sub = build_group(rows, meta_g)
                    final = _place_rows(final, sub, jnp.int32(g0))
                self.heavy_bank = final
        if self.prunable:
            self.heavy_ub, self.heavy_bits = build_tile_aux(self.heavy_bank)

    def build_rows_grouped(self, tids, weights):
        """Yield ``(g0, sub)`` device row groups for the given term ids,
        each ``sub`` an ``[rows+1, D]`` f32 sub-bank (trailing scatter-dump
        row) with row j = weights[g0+j]-scaled score row of tids[g0+j]
        (tid < 0 -> all-zero row). The on-demand form of the heavy-bank
        build: rows materialize per batch vocabulary instead of as a
        resident bank, the equal-memory WAND stance at 10M docs
        (WANDScorer.h:17-285 streams blocks, never holds dense rows).
        Bit-exact vs host_row (same LUT, same single IEEE multiply)."""
        pp = self.pp
        D = self.num_docs_pad
        R = len(tids)
        rowg = max(1, min(64, (_FLAT_SCATTER_MAX // D) - 1))
        packed_dev, norms_dev, lut_dev = self.device_decode_state()
        for g0 in range(0, R, rowg):
            rows = min(rowg, R - g0)
            bs, rid, sc = [], [], []
            for j in range(rows):
                t = int(tids[g0 + j])
                if t < 0:
                    continue
                b0 = int(pp.block_start[t])
                b1 = int(pp.block_start[t + 1])
                if b1 > b0:
                    bs.append(np.arange(b0, b1, dtype=np.int64))
                    rid.append(np.full(b1 - b0, j, np.int32))
                    sc.append(
                        np.full(
                            b1 - b0,
                            np.float32(weights[g0 + j]),
                            np.float32,
                        )
                    )
            sub = jnp.zeros((rows + 1, D), jnp.float32)
            if self.device is not None:
                sub = jax.device_put(sub, self.device)
            if bs:
                meta = _block_meta(
                    pp,
                    np.concatenate(bs),
                    np.concatenate(rid),
                    np.concatenate(sc),
                )
                sub = _scatter_bank_rows(
                    sub, meta, packed_dev, norms_dev, lut_dev, self.F,
                    self.device,
                )
            yield g0, sub


# ---------------------------------------------------------------------------
# Kernel
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("k",))
def row_score_topk(
    heavy_bank,  # f32 [H, D]
    light_bank,  # f32 [L, D] (row 0 all-zero)
    live,  # f32 [D]
    hidx,  # int32 [Q, Tq]  (-1 -> use light row)
    lidx,  # int32 [Q, Tq]
    scoring,  # bool [Q, Tq] clause contributes score (MUST/SHOULD)
    req,  # f32 [Q, Tq]
    sho,  # f32 [Q, Tq]
    neg,  # f32 [Q, Tq]
    bool_params,  # f32 [Q, 2]
    *,
    k: int,
):
    D = heavy_bank.shape[1]
    zero = jnp.zeros((D,), jnp.float32)
    one = jnp.ones((D,), jnp.float32)

    def one_query(hidx_q, lidx_q, sc_q, req_q, sho_q, neg_q, params_q):
        def step(carry, inp):
            scores, req_c, sho_c, neg_c = carry
            hi, li, sc, r, s, n = inp
            row = _row_for(hi, li, heavy_bank, light_bank)  # [D]
            scores = scores + jnp.where(sc, row, zero)
            present = row > 0
            ones = jnp.where(present, one, zero)
            req_c = req_c + r * ones
            sho_c = sho_c + s * ones
            neg_c = neg_c + n * ones
            return (scores, req_c, sho_c, neg_c), None

        (scores, req_c, sho_c, neg_c), _ = jax.lax.scan(
            step,
            (zero, zero, zero, zero),
            (hidx_q, lidx_q, sc_q, req_q, sho_q, neg_q),
        )
        num_required, min_should = params_q[0], params_q[1]
        mask = (
            (req_c == num_required)
            & (sho_c >= min_should)
            & (neg_c == 0)
            & ((req_c + sho_c) > 0)
            & (live > 0)
        )
        final = jnp.where(mask, scores, jnp.float32(-1.0))
        top_scores, top_docs = exact_topk(final, k)
        hits = jnp.sum(mask.astype(jnp.int32))
        return jnp.concatenate(
            [
                top_scores,
                top_docs.astype(jnp.float32),
                hits[None].astype(jnp.float32),
            ]
        )

    return jax.vmap(one_query)(
        hidx, lidx, scoring, req, sho, neg, bool_params
    )


@jax.jit
def row_count(
    heavy_bank, light_bank, live, hidx, lidx, scoring, req, sho, neg,
    bool_params,
):
    D = heavy_bank.shape[1]
    zero = jnp.zeros((D,), jnp.float32)
    one = jnp.ones((D,), jnp.float32)

    def one_query(hidx_q, lidx_q, req_q, sho_q, neg_q, params_q):
        def step(carry, inp):
            req_c, sho_c, neg_c = carry
            hi, li, r, s, n = inp
            row = _row_for(hi, li, heavy_bank, light_bank)
            ones = jnp.where(row > 0, one, zero)
            return (req_c + r * ones, sho_c + s * ones, neg_c + n * ones), None

        (req_c, sho_c, neg_c), _ = jax.lax.scan(
            step, (zero, zero, zero), (hidx_q, lidx_q, req_q, sho_q, neg_q)
        )
        mask = (
            (req_c == params_q[0])
            & (sho_c >= params_q[1])
            & (neg_c == 0)
            & ((req_c + sho_c) > 0)
            & (live > 0)
        )
        return jnp.sum(mask.astype(jnp.int32))

    return jax.vmap(one_query)(hidx, lidx, req, sho, neg, bool_params)


# ---------------------------------------------------------------------------
# Plans + executor
# ---------------------------------------------------------------------------


@dataclass
class CompactBatch:
    """Batch-compact clause-row bank + remapped plan arrays (built once
    per cached batch entry; consumed by row_score_topk_pruned_batch)."""

    compact_t: object  # f32 [G, U8, LANE] tile-major (exact rescore)
    compact_bf16: object  # bf16 [U8, D] (phase-1 matmul; booleans derive
    #                        presence from it in-kernel)
    cidx: object  # int32 [Q, Tq]
    cflags: object  # int32 [Q, Tq]
    a_sc_t: object  # bf16 [U8, Q]
    a_rq_t: object
    a_sh_t: object
    a_ng_t: object
    # combined rq*256 + sh indicator for the fused 2-matmul phase 1;
    # None when the batch has MUST_NOT clauses or a (row, query) pair
    # serves both roles (mixed digits are not bf16-exact)
    a_cb_t: object
    params_t: object  # f32 [8, Q]
    nbytes: int
    # phase-1 replay cache {Bk: (tsel, u_next, min_unsel, hits)} — the
    # LRUQueryCache role (Lucene caches per-(query, segment) scoring
    # state across searches; on by default there too): tile selection,
    # certificates and hit counts are a pure function of (batch plans,
    # bank, live, Bk), all immutable for this object's lifetime, so a
    # RE-ISSUED identical batch replays them and runs only the exact
    # phase-2 rescore. Serving feature only: benches measure with
    # query_cache=False so qps stays comparable to the reference's
    # full-rescore-per-iteration numbers.
    p1_cache: dict = field(default_factory=dict)
    # ---- phase-0 (on-demand scale) state; None on phase-1 entries ----
    # Phase-0 replaces the full-D bf16 matmul with per-row TILE maxima
    # bounds (the block-max metadata of WANDScorer.h in batch-matmul
    # form): selection cost drops from Q*U8*D MACs to Q*U8*G, and exact
    # hit counts ride the 32x-denser presence bitmaps (bits_hits).
    # Eligibility (min_should <= 1 for every query) is decided at build;
    # eligible entries skip the bf16 bank entirely (entry bytes drop
    # from 6*D*U8 to ~4.2*D*U8, so more entries stay cached at 10M
    # docs under the same budget).
    ubank: object = None  # f32 [U8, G] per-row tile maxima
    bits: object = None  # u32 [U8, G*4] per-row live presence bitmaps
    qmode: object = None  # i32 [Q] bits_hits MODE_* words
    a_sc_f: object = None  # f32 [U8, Q] (phase-0 bound matmul)
    a_rq_f: object = None
    a_sh_f: object = None


@dataclass
class RowPlan:
    hidx: np.ndarray  # int32 [Tq_pad]
    # per-plan light entries, one per lidx slot: an np.ndarray is a
    # host-materialized row (ranges/nested indicators); an (tid, weight)
    # tuple is a term row the executor decodes ON DEVICE at stack time
    # (a few KB of block metadata instead of a [D] f32 row per clause
    # over the host link)
    light_entries: list
    lidx: np.ndarray  # int32 [Tq_pad] (index into plan-local light rows +1;
    #                   0 = the shared zero row)
    scoring: np.ndarray  # bool [Tq_pad]
    req: np.ndarray
    sho: np.ndarray
    neg: np.ndarray
    num_required: int
    min_should: int
    pure_or: bool = False  # SHOULD-only, minShouldMatch <= 1
    _dev: object = None  # cached device light bank


class RowExecutor:
    def __init__(self, index: RowFieldIndex):
        from collections import OrderedDict

        self.index = index
        # LRU keyed by plan identity, bounded by device bytes (compact
        # banks dominate; see BATCH_CACHE_BUDGET)
        self._batch_cache: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._batch_bytes = 0
        self._part_cache: dict = {}
        # batch-shape decisions (dedup map / purity split) cached by plan
        # identity: rebuilding them eagerly cost ~12 ms of host time per
        # dispatch on this 1-core box (profiled), dwarfing the device work
        self._dedup_cache: dict = {}
        self._split_cache: dict = {}
        # on-demand exhaustive-args banks (escalation/count), tiny LRU
        self._demand_args_cache: dict = {}
        # pruning observability (the reference instruments WAND with
        # per-query counters, WANDScorer.h:99-141); silent perf cliffs —
        # certificate escalations, compact-bank fallbacks — show up here
        from diagon_tpu.observability.metrics import registry

        self.metrics = {
            "pruned": registry.counter(
                "search.pruned_dispatches",
                "query batches scored via the pruned (block-max) path",
            ),
            "exhaustive": registry.counter(
                "search.exhaustive_dispatches",
                "query batches scored exhaustively",
            ),
            "escalations": registry.counter(
                "search.escalations",
                "queries re-run exhaustively after a certificate failure",
            ),
            "compact_fallbacks": registry.counter(
                "search.compact_fallbacks",
                "batches that could not build a compact bank",
            ),
            "partitions": registry.counter(
                "search.compact_partitions",
                "batches partitioned into vocabulary groups",
            ),
            "tiles": registry.counter(
                "search.tiles_rescored",
                "(query, tile) pairs rescored by the pruned phase 2",
            ),
        }

    def build_plan(self, term_plans, min_should: int,
                   idf_of_tid) -> RowPlan:
        """term_plans: engine.TermPlan list in oracle order. Clauses with
        boost-adjusted weights or light terms get host rows."""
        idx = self.index
        n = len(term_plans)
        tq = _bucket_tq(n)
        hidx = np.full(tq, -1, dtype=np.int32)
        lidx = np.zeros(tq, dtype=np.int32)
        scoring = np.zeros(tq, dtype=bool)
        req = np.zeros(tq, dtype=np.float32)
        sho = np.zeros(tq, dtype=np.float32)
        neg = np.zeros(tq, dtype=np.float32)
        light_entries: list = []
        num_required = 0

        for i, tp in enumerate(term_plans):
            if tp.required:
                num_required += 1
            present = tp.term_id >= 0 or tp.host_row is not None
            scoring[i] = (not tp.negated) and tp.weight != 0.0
            req[i] = 1.0 if (tp.required and present) else 0.0
            sho[i] = 1.0 if (tp.should and present) else 0.0
            neg[i] = 1.0 if (tp.negated and present) else 0.0
            if not present:
                continue
            if tp.host_row is not None:
                row = np.zeros(idx.num_docs_pad, dtype=np.float32)
                row[: len(tp.host_row)] = np.asarray(
                    tp.host_row, dtype=np.float32
                )
                light_entries.append(row)
                lidx[i] = len(light_entries)
                continue
            hrow = (
                idx.heavy_row_of_term[tp.term_id]
                if idx.heavy_row_of_term is not None
                else -1
            )
            # heavy bank rows are scaled by the term's collection idf; a
            # clause whose weight differs (boost != 1, or FILTER/MUST_NOT
            # where weight==0 but we still need presence) can use the bank
            # row when only PRESENCE matters (non-scoring clauses).
            bank_ok = hrow >= 0 and (
                (not scoring[i])
                or np.float32(tp.weight) == idf_of_tid(tp.term_id)
            )
            if bank_ok:
                hidx[i] = hrow
            else:
                w = np.float32(tp.weight) if scoring[i] else np.float32(1.0)
                light_entries.append((int(tp.term_id), w))
                lidx[i] = len(light_entries)  # +1 offset (0 = zero row)
        # Pure-OR fast path requires every clause's row to satisfy
        # "row > 0 iff clause matches AND contributes score" — nested
        # subquery A/B pairs (score-only + presence-only rows) break that,
        # so ALL plans must be scoring SHOULD clauses.
        pure_or = (
            num_required == 0
            and min_should <= 1
            and not any(tp.negated for tp in term_plans)
            and all(
                tp.should and tp.weight != 0.0 for tp in term_plans
            )
        )
        return RowPlan(
            hidx, light_entries, lidx, scoring, req, sho, neg,
            num_required, min_should, pure_or,
        )

    def _build_light_bank(self, total, specs, host_rows):
        """Assemble the batch light bank. Term specs decode ON DEVICE
        (chunked flat scatter from the resident packed stream — a few KB
        of block metadata instead of a 4*D-byte row per clause over the
        host link); host-materialized rows (range/nested indicators)
        upload individually. Falls back to full host assembly when the
        flat scatter cannot index the bank (huge D * many rows)."""
        idx = self.index
        D = idx.num_docs_pad
        nrows = _bucket(total + 1, minimum=1)
        if specs and (nrows + 1) * D < _FLAT_SCATTER_MAX:
            import jax as _jax

            packed_dev, norms_dev, lut_dev = idx.device_decode_state()
            pp = idx.pp
            bank = jnp.zeros((nrows + 1, D), jnp.float32)  # last = dump
            if idx.device is not None:
                bank = _jax.device_put(bank, idx.device)
            bs, rid, sc = [], [], []
            for r, tid, w in specs:
                b0 = int(pp.block_start[tid])
                b1 = int(pp.block_start[tid + 1])
                if b1 > b0:
                    bs.append(np.arange(b0, b1, dtype=np.int64))
                    rid.append(np.full(b1 - b0, r, np.int32))
                    sc.append(np.full(b1 - b0, np.float32(w), np.float32))
            if bs:
                meta = _block_meta(
                    pp,
                    np.concatenate(bs),
                    np.concatenate(rid),
                    np.concatenate(sc),
                )
                bank = _scatter_bank_rows(
                    bank, meta, packed_dev, norms_dev, lut_dev,
                    idx.F, idx.device,
                )
            for r, arr in host_rows:
                bank = _set_bank_row(
                    bank, jnp.asarray(arr), jnp.int32(r)
                )
            return bank
        bank = np.zeros((nrows, D), dtype=np.float32)
        for r, tid, w in specs:
            bank[r] = idx.host_row(tid, w)
        for r, arr in host_rows:
            bank[r] = arr
        return jnp.asarray(bank)

    def _stack(self, plans: Sequence[RowPlan]):
        # clause-count bucket: every scan step costs [Q, *] traffic, so use
        # the tight multiple-of-4 bucket, not the power-of-2 one
        tq = _bucket_tq(max(len(p.hidx) for p in plans))

        def pad(get, dtype, fill=0):
            out = np.full((len(plans), tq), fill, dtype=dtype)
            for i, p in enumerate(plans):
                v = get(p)
                out[i, : len(v)] = v
            return out

        # light bank: per-plan entries remapped into one bank, DEDUPED
        # across the batch ((tid, weight) term rows and identical host
        # rows shared — a 1024-query mixed batch over a common vocabulary
        # collapses from ~Q*Tq rows to its unique vocabulary). Term rows
        # decode ON DEVICE from the packed stream; host-materialized rows
        # (ranges/nested indicators) upload.
        lidx = pad(lambda p: p.lidx, np.int32)
        specs = []  # (bank_row, tid, weight)
        host_rows = []  # (bank_row, np row)
        row_of: dict = {}  # entry key -> shared bank row (1-based)
        for qi, p in enumerate(plans):
            if not p.light_entries:
                continue
            remap = np.zeros(len(p.light_entries) + 1, dtype=np.int32)
            for j, e in enumerate(p.light_entries):
                key = (
                    ("t", int(e[0]), float(e[1]))
                    if isinstance(e, tuple)
                    else ("h", id(e))
                )
                r = row_of.get(key)
                if r is None:
                    r = len(row_of) + 1
                    row_of[key] = r
                    if isinstance(e, tuple):
                        specs.append((r, e[0], e[1]))
                    else:
                        host_rows.append((r, e))
                remap[j + 1] = r
            lidx[qi] = remap[lidx[qi]]
        total = len(row_of)
        light_bank = self._build_light_bank(total, specs, host_rows)
        # tile aux serves only the small-batch tile-UB path, which huge
        # (on-demand) segments never take — skip its bank-sized temps
        light_aux = (
            build_tile_aux(light_bank)
            if self.index.prunable and not self.index.bank_on_demand
            else (None, None)
        )
        hidx_arr = pad(lambda p: p.hidx, np.int32, fill=-1)
        sc_arr = pad(lambda p: p.scoring, bool)
        rq_arr = pad(lambda p: p.req, np.float32)
        sh_arr = pad(lambda p: p.sho, np.float32)
        ng_arr = pad(lambda p: p.neg, np.float32)
        compact = None
        pure_or = all(p.pure_or for p in plans)
        if (
            self.index.prunable
            and (
                self.index.heavy_bank is not None
                or self.index.bank_on_demand
            )
            and (
                len(plans) >= self.approx_min_q
                or not pure_or
                or self.index.num_docs_pad >= self.batch_only_min_docs
                or self._force_batch
            )
        ):
            compact = self._build_compact(
                hidx_arr, lidx, sc_arr, rq_arr, sh_arr, ng_arr,
                light_bank, total, plans, pure_or,
            )
        return (
            jnp.asarray(hidx_arr),
            jnp.asarray(lidx),
            jnp.asarray(sc_arr),
            jnp.asarray(rq_arr),
            jnp.asarray(sh_arr),
            jnp.asarray(ng_arr),
            jnp.asarray(
                [[p.num_required, p.min_should] for p in plans], jnp.float32
            ),
            light_bank,
            light_aux,
            compact,
        )

    # batch-compact banks beyond this many rows would not fit the phase-1
    # kernel's [U8, 128] bank tiles in a GPU block's shared memory; larger
    # batches are PARTITIONED into
    # contiguous query groups under the cap (see _partition_plans) and only
    # fall back to exhaustive scoring when a single query alone exceeds it
    COMPACT_MAX_ROWS = 512
    # device bytes a group's banks may occupy (light f32 + tile-major f32 +
    # bf16 ~ 10 bytes/doc/row); shrinks the per-group row cap on huge
    # segments so partitioned diverse batches can't OOM the bank builds
    COMPACT_GROUP_BYTES = 2 << 30

    # on-demand mode transient row-group cap: with no resident heavy
    # bank the compact banks own most of HBM (ON_DEMAND_CACHE_BUDGET),
    # so the build's transient [rows, D] f32 group must stay small —
    # 4 GB = ~100 rows at 10M docs, built in as many group passes as
    # needed, so a group plus the 7 GB entry cache fit a 16 GB budget.
    ON_DEMAND_GROUP_BYTES = 4 << 30

    def _compact_row_cap(self) -> int:
        D = self.index.num_docs_pad
        if self.index.bank_on_demand:
            per_row = 5 * D if self.use_phase0 else 7 * D
            return min(self.COMPACT_MAX_ROWS,
                       max(32, self.ON_DEMAND_GROUP_BYTES // per_row))
        return min(self.COMPACT_MAX_ROWS,
                   max(32, self.COMPACT_GROUP_BYTES // (10 * D)))

    @staticmethod
    def _plan_row_keys(p: "RowPlan") -> set:
        keys = {int(h) for h in p.hidx if h >= 0}
        for e in p.light_entries:
            keys.add(
                ("t", int(e[0]), float(e[1]))
                if isinstance(e, tuple)
                else ("h", id(e))
            )
        return keys

    def _partition_plans(self, plans: Sequence[RowPlan]):
        """Contiguous query groups whose DEDUPED clause-row vocabulary each
        fits the compact cap; None when the whole batch fits (common case).
        A plan that alone exceeds the cap gets its own group (its group
        then takes the exhaustive fallback)."""
        cap = self._compact_row_cap()
        per_plan = [self._plan_row_keys(p) for p in plans]
        # the cap must admit the largest single plan, or a homogeneous
        # batch of wide queries would shatter into per-query groups that
        # STILL cannot build a compact bank (the hard row limit,
        # COMPACT_MAX_ROWS, is enforced separately by _build_compact)
        cap = max(cap, max(len(ks) for ks in per_plan) + 1)
        all_keys = set().union(*per_plan) if per_plan else set()
        if len(all_keys) + 1 <= cap:
            return None
        groups = []
        cur: set = set()
        start = 0
        for i, keys in enumerate(per_plan):
            merged = cur | keys
            if cur and len(merged) + 1 > cap:
                groups.append((start, i))
                start = i
                cur = set(keys)
            else:
                cur = merged
        groups.append((start, len(plans)))
        return groups

    def _build_compact(self, hidx_arr, lidx, sc_arr, rq_arr, sh_arr,
                       ng_arr, light_bank, n_light, plans, pure_or):
        """CompactBatch — the batch's clause rows compacted into one small
        bank (f32 tile-major for the exact rescore + bf16/presence row-
        major for phase 1) with per-clause indices remapped, so BOTH
        pruned phases scale with the batch's vocabulary, not the corpus's
        heavy-term count. Row 0 is the shared zero row; padding clauses
        keep cidx 0."""
        used = np.unique(hidx_arr[hidx_arr >= 0])
        n_rows = 1 + len(used) + n_light
        if n_rows > self.COMPACT_MAX_ROWS:
            return None
        hpos = np.full(
            int(used.max()) + 1 if len(used) else 1, 0, dtype=np.int32
        )
        hpos[used] = 1 + np.arange(len(used), dtype=np.int32)
        cidx = np.where(
            hidx_arr >= 0,
            hpos[np.maximum(hidx_arr, 0)],
            np.where(lidx > 0, 1 + len(used) + (lidx - 1), 0),
        ).astype(np.int32)
        cflags = (
            sc_arr.astype(np.int32)
            + 2 * (rq_arr > 0).astype(np.int32)
            + 4 * (sh_arr > 0).astype(np.int32)
            + 8 * (ng_arr > 0).astype(np.int32)
        )
        D = self.index.num_docs_pad
        phase0 = (
            self.use_phase0
            and self.index.bank_on_demand
            and all(p.min_should <= 1 for p in plans)
        )
        if self.index.bank_on_demand:
            # no resident heavy bank at this scale: scatter-build exactly
            # the rows this batch uses from the packed postings, placing
            # each row group straight into the (donated) tile-major f32
            # (+ bf16 for phase-1 entries) banks — peak residency =
            # banks + one transient group. Phase-0 entries skip the bf16
            # bank: selection rides tile maxima, hits ride bitmaps.
            idx = self.index
            G = D // LANE
            U8 = bank_rows(n_rows)
            compact_t = jnp.zeros((G, U8, LANE), jnp.float32)
            compact_bf16 = None
            if not phase0:
                compact_bf16 = jnp.zeros((U8, D), jnp.bfloat16)
            if idx.device is not None:
                compact_t = jax.device_put(compact_t, idx.device)
                if compact_bf16 is not None:
                    compact_bf16 = jax.device_put(compact_bf16, idx.device)
            if len(used):
                tids = idx.heavy_tid_of_row[used]
                ws = idx.heavy_weight[used]
                for g0, sub in idx.build_rows_grouped(tids, ws):
                    if phase0:
                        compact_t = _compact_place_t(
                            compact_t, sub, jnp.int32(1 + g0)
                        )
                    else:
                        compact_t, compact_bf16 = _compact_place(
                            compact_t, compact_bf16, sub, jnp.int32(1 + g0)
                        )
            for j in range(n_light):
                row = jax.lax.dynamic_slice_in_dim(
                    light_bank, 1 + j, 1, 0
                )
                if phase0:
                    compact_t = _compact_place_row_t(
                        compact_t, row, jnp.int32(1 + len(used) + j)
                    )
                else:
                    compact_t, compact_bf16 = _compact_place_row(
                        compact_t, compact_bf16, row,
                        jnp.int32(1 + len(used) + j),
                    )
        else:
            # ONE jitted shape-bucketed assembly: an eager build
            # (heavy_bank[used] gather + exact-size concatenates) traces
            # a NEW program for every distinct (len(used), n_light), so
            # a fresh serving batch would pay a dozen XLA compiles.
            # Bucketing the gather width and light count (32/8) makes
            # novel batches reuse the compiled assembly.
            u8 = bank_rows(n_rows, 32)
            ub = -(-max(len(used), 1) // 32) * 32
            lb = -(-max(n_light, 1) // 8) * 8
            # assemble at a size that can hold BOTH bucketed blocks
            # without dynamic_update_slice clamping (which would shift
            # the block instead of writing past the end), then slice to
            # the entry's bucketed row count
            u8_build = max(u8, -(-(1 + ub + lb) // 32) * 32)
            used_pad = np.zeros(ub, np.int32)
            used_pad[: len(used)] = used
            used_mask = np.zeros(ub, np.float32)
            used_mask[: len(used)] = 1.0
            light_mask = np.zeros(lb, np.float32)
            light_mask[:n_light] = 1.0
            compact_f32 = _assemble_compact(
                self.index.heavy_bank, jnp.asarray(used_pad),
                jnp.asarray(used_mask), light_bank,
                jnp.asarray(light_mask), jnp.int32(len(used)),
                u8=u8_build, lb=lb,
            )
            if u8 < u8_build:
                compact_f32 = compact_f32[:u8]
            U8 = u8
            compact_t = _tile_major(compact_f32)
            compact_bf16 = compact_f32.astype(jnp.bfloat16)
        if phase0:
            # phase-0 metadata: per-row tile maxima + live presence
            # bitmaps (two bank reads, once per cached entry build)
            ubank = _ubank_from_tiles(compact_t)
            bits = _build_bits_bank(
                compact_t, self.index.live, self.index.device
            )
            # f32 tile-major + bits + ubank (no bf16 bank)
            nbytes = U8 * D * 4 + U8 * (D // 8) + U8 * (D // LANE) * 4
        else:
            ubank = bits = None
            nbytes = U8 * D * 6  # f32 tile-major + bf16

        # transposed per-role clause-indicator matrices for phase 1
        nq, tq = cidx.shape
        a = {
            r: np.zeros((U8, nq), np.float32)
            for r in ("sc", "rq", "sh", "ng")
        }
        qgrid = np.broadcast_to(np.arange(nq)[:, None], cidx.shape)
        for r, marr in (
            ("sc", sc_arr),
            ("rq", rq_arr > 0),
            ("sh", sh_arr > 0),
            ("ng", ng_arr > 0),
        ):
            m = marr.astype(bool) & (cidx > 0)
            np.add.at(a[r], (cidx[m], qgrid[m]), 1.0)
        params = np.zeros((8, nq), np.float32)
        params[0] = [p.num_required for p in plans]
        params[1] = [p.min_should for p in plans]
        dev = jnp.asarray
        a_cb = None
        if not pure_or and not a["ng"].any() and not (
            (a["rq"] > 0) & (a["sh"] > 0)
        ).any() and a["rq"].max(initial=0) < 256:
            a_cb = dev(a["rq"] * np.float32(256.0) + a["sh"]).astype(
                jnp.bfloat16
            )
        qmode_dev = a_sc_f = a_rq_f = a_sh_f = None
        if phase0:
            qmode = np.zeros(nq, np.int32)
            for qi, p in enumerate(plans):
                if p.num_required > 0:
                    qmode[qi] |= MODE_REQ
                    if int((rq_arr[qi] > 0).sum()) < p.num_required:
                        qmode[qi] |= MODE_DEAD
                if p.min_should >= 1 or p.num_required == 0:
                    qmode[qi] |= MODE_SHO
            qmode_dev = dev(qmode)
            a_sc_f = dev(a["sc"])
            a_rq_f = dev(a["rq"])
            a_sh_f = dev(a["sh"])
        return CompactBatch(
            compact_t,
            compact_bf16,
            dev(cidx),
            dev(cflags),
            dev(a["sc"]).astype(jnp.bfloat16),
            dev(a["rq"]).astype(jnp.bfloat16),
            dev(a["sh"]).astype(jnp.bfloat16),
            dev(a["ng"]).astype(jnp.bfloat16),
            a_cb,
            dev(params),
            nbytes,
            ubank=ubank,
            bits=bits,
            qmode=qmode_dev,
            a_sc_f=a_sc_f,
            a_rq_f=a_rq_f,
            a_sh_f=a_sh_f,
        )

    # total device bytes the batch-entry LRU may hold (compact banks are
    # ~8 bytes/doc/unique-row; at 1M docs an OR-20 entry is ~190 MB).
    # Sized so a purity-split mixed batch (one pure-OR + one boolean
    # compact entry, ~1.1 GB + ~1.4 GB at 1M docs) AND the or20 batch all
    # stay resident — at 2 GB the split pair thrashes the LRU and
    # rebuilds a compact bank every dispatch
    BATCH_CACHE_BUDGET = 5 << 30
    # on-demand (huge-segment) budget: no resident heavy bank, so the
    # compact entries own HBM. At 10M docs the purity-split mixed
    # entries (~2.4 + ~2.9 GB at pool 32) AND the or20 entry (~1.4 GB)
    # must ALL stay resident, or the LRU evicts one split entry to admit
    # the other every dispatch and each batch pays a bank rebuild.
    ON_DEMAND_CACHE_BUDGET = 7 << 30

    def _cache_budget(self) -> int:
        if self.index.bank_on_demand:
            return self.ON_DEMAND_CACHE_BUDGET
        return self.BATCH_CACHE_BUDGET

    def _entry(self, plans: Sequence[RowPlan]):
        ck = tuple(id(p) for p in plans)
        entry = self._batch_cache.get(ck)
        if entry is None:
            # evict BEFORE building: the old evict-after-insert policy let
            # peak residency reach old entries + the new entry's banks,
            # which overflows a 16 GB budget at 10M docs.
            # The estimate overshoots (12 B/doc/row covers f32 tile-major
            # + bf16 + presence + light f32) — over-eviction only costs a
            # rebuild, under-eviction costs the device.
            vocab = set()
            for p in plans:
                vocab |= self._plan_row_keys(p)
            budget = self._cache_budget()
            # per-row byte estimates must track the REAL entry cost
            # closely in on-demand mode: the old blanket 12 B/doc/row
            # (vs 6 real for f32 tile-major + bf16) made a ~2.9 GB
            # split entry claim ~4.9 GB and evict its resident sibling,
            # rebuilding every dispatch at 10M docs
            if self.index.bank_on_demand:
                per_row = 5 if self.use_phase0 else 7
            else:
                per_row = 12
            est = per_row * self.index.num_docs_pad * (len(vocab) + 9)
            while (
                self._batch_bytes + est > budget
                and self._batch_cache
            ):
                _, (_, _, nb) = self._batch_cache.popitem(last=False)
                self._batch_bytes -= nb
            stacked = self._stack(plans)
            compact = stacked[-1]
            nbytes = (
                compact.nbytes if compact is not None else 0
            ) + stacked[7].nbytes  # light bank
            entry = (list(plans), stacked, nbytes)
            self._batch_bytes += nbytes
            self._batch_cache[ck] = entry
            while (
                self._batch_bytes > budget
                and len(self._batch_cache) > 1
            ):
                _, (_, _, nb) = self._batch_cache.popitem(last=False)
                self._batch_bytes -= nb
        else:
            self._batch_cache.move_to_end(ck)
        return entry

    def _args(self, plans: Sequence[RowPlan]):
        (
            hidx, lidx, scoring, req, sho, neg, bool_params, light_bank,
            _aux, _amats,
        ) = self._entry(plans)[1]
        heavy = self.index.heavy_bank
        if heavy is None and self.index.bank_on_demand:
            heavy, hidx = self._demand_heavy_args(plans, hidx)
        return (
            heavy,
            light_bank,
            self.index.live,
            hidx,
            lidx,
            scoring,
            req,
            sho,
            neg,
            bool_params,
        )

    def _demand_heavy_args(self, plans, hidx):
        """On-demand exhaustive/count/escalation support: a row-major
        bank of just the heavy rows THIS batch uses, scatter-built from
        postings, with hidx remapped into it. Cached per plan identity
        (escalation reruns / repeated counts); bounded small — these
        paths are rare at on-demand scale."""
        ck = tuple(id(p) for p in plans)
        hit = self._demand_args_cache.get(ck)
        if hit is not None:
            return hit
        idx = self.index
        hidx_np = np.asarray(hidx)
        used = np.unique(hidx_np[hidx_np >= 0])
        if len(used) == 0:
            bank = jnp.zeros((1, idx.num_docs_pad), jnp.float32)
            if idx.device is not None:
                bank = jax.device_put(bank, idx.device)
            out = (bank, jnp.asarray(hidx_np))
        else:
            final = jnp.zeros((len(used), idx.num_docs_pad), jnp.float32)
            if idx.device is not None:
                final = jax.device_put(final, idx.device)
            for g0, sub in idx.build_rows_grouped(
                idx.heavy_tid_of_row[used], idx.heavy_weight[used]
            ):
                final = _place_rows(final, sub, jnp.int32(g0))
            hpos = np.zeros(int(used.max()) + 1, dtype=np.int32)
            hpos[used] = np.arange(len(used), dtype=np.int32)
            hidx2 = np.where(
                hidx_np >= 0, hpos[np.maximum(hidx_np, 0)], -1
            ).astype(np.int32)
            out = (final, jnp.asarray(hidx2))
        if len(self._demand_args_cache) >= 4:
            self._demand_args_cache.pop(
                next(iter(self._demand_args_cache))
            )
        self._demand_args_cache[ck] = out
        return out

    # phase-0 tile-maxima selection + bitmap hit counts for on-demand
    # (huge-segment) batches. Default OFF: the tile-maxima bounds are
    # looser than the per-doc phase 1 and escalate more queries; its
    # entries skip the bf16 bank (~4.2 B/doc/row vs ~6.3), so it remains
    # available for memory-constrained deployments. Whether it should
    # become the default is an open measurement.
    use_phase0: bool = False
    # LRUQueryCache role: replay phase-1 scoring state when an identical
    # batch is re-issued (staged/huge-segment path only). Default on,
    # like the reference's searcher-level query cache; benches turn it
    # off so measured qps re-scores every iteration
    query_cache: bool = True
    # transient: a deduped homogeneous burst routes through the batch
    # compact path even at sub-batch sizes (set around dispatch recursion)
    _force_batch: bool = False
    # block-max pruning knobs (instance-overridable; tests force small ones)
    prune_min_docs: int = PRUNE_MIN_DOCS
    prune_B0: int = PRUNE_B0
    # batches at least this large route phase 1 through the approx matmul
    # (the bank read amortizes across the batch); below it, per-clause
    # tile-UB rows are cheaper
    approx_min_q: int = 8
    # segments at least this large ALWAYS use the batch path (see
    # _dispatch_pruned: the small-batch kernel's bank reshape copy is
    # fatal at 10M docs)
    batch_only_min_docs: int = 4 << 20

    # below this segment size, single/small dispatches stay exhaustive:
    # pruning saves little at small D, and a certificate-failure
    # escalation costs a second device round-trip per dispatch
    prune_solo_min_docs: int = 1 << 18

    def _use_pruned(self, plans: Sequence[RowPlan]) -> bool:
        if not (
            self.index.prunable
            and (
                self.index.heavy_ub is not None
                or self.index.bank_on_demand
            )
            and self.index.num_docs_pad >= self.prune_min_docs
        ):
            return False
        if (
            self.index.num_docs_pad < self.prune_solo_min_docs
            and len(plans) < self.approx_min_q
        ):
            return False
        if all(p.pure_or for p in plans):
            return True
        # general booleans prune only in batch mode (the presence-count
        # matmuls need the batch to amortize the bank reads)
        return len(plans) >= self.approx_min_q

    def _dispatch_pruned(self, plans: Sequence[RowPlan], k: int,
                         out_q: int = None):
        """Pruned dispatch; returns None when the batch cannot prune
        (compact bank too large) so dispatch() falls back to exhaustive.
        ``out_q``: slice the fused result to the first out_q queries
        INSIDE the batch program (Q-bucket padding removal for free)."""
        (
            hidx, lidx, _scoring, _req, _sho, _neg, bool_params, light_bank,
            light_aux, compact,
        ) = self._entry(plans)[1]
        idx = self.index
        G = idx.num_docs_pad // LANE
        # tile budget scales with the tile count: the phase-1 bound is
        # inflated by _APPROX_RELEPS (~0.8%), and at 10M docs the tile-max
        # density near theta is ~60 tiles per 1% — B=32 left u_next inside
        # the inflation margin and escalated EVERY query (measured);
        # G//512 (=152 at 10M) certifies with margin.
        B = min(G, max(self.prune_B0, -(-k // LANE) + 1, G // 512))
        pure_or = all(p.pure_or for p in plans)
        # the tile-UB small-batch kernel reshapes the full heavy bank to
        # [H*G, LANE], which forces a bank-sized relayout copy — fatal at
        # 10M docs; huge segments always take the compact batch path
        batch_mode = (
            len(plans) >= self.approx_min_q
            or not pure_or
            or idx.num_docs_pad >= self.batch_only_min_docs
            or idx.bank_on_demand  # no resident bank for the solo path
            or self._force_batch
        )
        if batch_mode:
            if compact is None:
                return None  # compact bank too large: exhaustive
            self.metrics["tiles"].increment(len(plans) * B)
            if compact.ubank is not None:
                # phase-0 route (on-demand scale): tile-maxima bounds +
                # bitmap hit counts; same phase-2 + certificates
                Bk = min(B, G)
                tsel, u_next, min_unsel = _pruned_batch_phase0(
                    compact.ubank, compact.a_sc_f, compact.a_rq_f,
                    compact.a_sh_f, compact.params_t,
                    Bk=Bk, boolean=not pure_or,
                )
                hits = bits_hits(
                    compact.bits, compact.cidx, compact.cflags,
                    compact.qmode,
                )
                fused = _pruned_batch_phase2(
                    compact.compact_t, compact.cidx, compact.cflags,
                    idx.live, tsel, u_next, min_unsel, hits,
                    bool_params, k=k, boolean=not pure_or,
                )
                if out_q is not None and out_q != len(plans):
                    fused = fused[:out_q]
                return fused
            return row_score_topk_pruned_batch(
                compact.compact_t,
                compact.compact_bf16,
                compact.cidx,
                compact.cflags,
                idx.live,
                compact.a_sc_t,
                compact.a_rq_t,
                compact.a_sh_t,
                compact.a_ng_t,
                compact.params_t,
                bool_params,
                k=k,
                B=B,
                boolean=not pure_or,
                a_cb_t=compact.a_cb_t,
                # the staged two-program pipeline is an HBM-headroom
                # measure for huge segments; below that, one fused
                # program saves two host dispatches per batch
                staged=idx.num_docs_pad >= self.batch_only_min_docs,
                out_q=out_q,
                p1_cache=compact.p1_cache if self.query_cache else None,
            )
        # small pure-OR batches: per-clause tile-UB bounds (one [G] row
        # per clause beats a whole-bank matmul below approx_min_q)
        light_ub, light_bits = light_aux
        if light_ub is None:  # zero-row-only bank never hits the light path
            light_ub = jnp.zeros((1, G), jnp.float32)
            light_bits = jnp.zeros(
                (1, idx.num_docs_pad // 32), jnp.uint32
            )
        fused = row_score_topk_pruned_or(
            idx.heavy_bank,
            light_bank,
            idx.heavy_ub,
            light_ub,
            idx.heavy_bits,
            light_bits,
            idx.live,
            idx.live_bits,
            hidx,
            lidx,
            k=k,
            B=B,
        )
        if out_q is not None and out_q != len(plans):
            fused = fused[:out_q]
        return fused

    @staticmethod
    def _bucket_q(q: int) -> int:
        """Batch-length bucket: serving batches vary by a few queries
        between calls (purity splits, dedup) and every distinct Q is a
        fresh XLA compile (~0.7 s/kernel pair, measured 14 s for one new
        1024-query mixed batch). Bounded buckets cap overhead at ~12%.

        Below 8 the buckets are powers of two: a homogeneous serving
        burst dedups to ONE unique plan, and padding it 1 -> 8 octuples
        phase-1 product columns AND phase-2 tile rescores — measured as
        the or20-10M regression 18.4x -> 11.6x (the pad landed in
        ad42672 between the two recorded runs)."""
        if q <= 8:
            return max(1, 1 << (q - 1).bit_length())
        if q <= 64:
            return -(-q // 8) * 8
        if q <= 256:
            return -(-q // 64) * 64
        return -(-q // 128) * 128

    def _pad_plan(self) -> "RowPlan":
        """Singleton match-nothing pure-OR plan used to pad batches up to
        the Q bucket (absent term: zero row, zero hits)."""
        p = getattr(self, "_pad_plan_cache", None)
        if p is None:
            from diagon_tpu.search.engine import TermPlan

            # weight 1.0 (not 0.0): pure_or requires every clause to be
            # scoring, and a non-pure-or pad plan silently dragged every
            # PADDED pure-OR subset through the 4-product boolean kernel.
            # The term is absent (-1) so the clause still contributes a
            # zero row: score 0, hits 0, at any weight.
            p = self.build_plan(
                [TermPlan(-1, np.float32(1.0), should=True)],
                min_should=1,
                idf_of_tid=lambda tid: np.float32(0.0),
            )
            self._pad_plan_cache = p
        return p

    def _pad_batch(self, plans):
        """(padded_plans, original_q) — pad to the Q bucket so repeated
        serving batches of drifting sizes reuse one compiled kernel."""
        q = len(plans)
        qp = self._bucket_q(q)
        if qp == q:
            return plans, q
        return list(plans) + [self._pad_plan()] * (qp - q), q

    def dispatch(self, plans: Sequence[RowPlan], k: int):
        # identical-plan dedup: a homogeneous serving burst (the same
        # query fanned across a batch) scores once per UNIQUE plan and
        # broadcasts the fused rows — phase 1's per-query product columns
        # are the dominant cost and identical plans produce identical rows
        if len(plans) > 1:
            ck = tuple(map(id, plans))
            hit = self._dedup_cache.get(ck, None)
            if hit is None:
                uniq_of: dict = {}
                uniq = []
                for p in plans:
                    if id(p) not in uniq_of:
                        uniq_of[id(p)] = len(uniq)
                        uniq.append(p)
                if len(uniq) < len(plans):
                    take = jnp.asarray(
                        [uniq_of[id(p)] for p in plans], jnp.int32
                    )
                    hit = (uniq, take)
                else:
                    hit = False
                if len(self._dedup_cache) > 128:
                    self._dedup_cache.clear()
                self._dedup_cache[ck] = hit
            if hit:
                uniq, take = hit
                # the deduped sub-batch stands for a LARGE batch: route it
                # through the batch compact path (the solo tile-UB path's
                # sum-of-maxes bound is loose and escalates at scale)
                prev = self._force_batch
                self._force_batch = True
                try:
                    fused_u = self.dispatch(uniq, k)
                finally:
                    self._force_batch = prev
                return _take_rows(fused_u, take)
        if self._use_pruned(plans):
            # purity split: a single boolean plan would otherwise drag the
            # WHOLE batch through the 4-product boolean phase-1 kernel;
            # score the pure-OR majority on the 1-product kernel and only
            # the boolean subset on the boolean kernel, then restore order
            ck = tuple(map(id, plans))
            sp = self._split_cache.get(ck, None)
            if sp is None:
                po = [p.pure_or for p in plans]
                n_or = sum(po)
                if 0 < n_or < len(plans):
                    idx_or = np.asarray(
                        [i for i, f in enumerate(po) if f], np.int32
                    )
                    idx_bool = np.asarray(
                        [i for i, f in enumerate(po) if not f], np.int32
                    )
                    # inv permutations are built per PADDED f1 row count
                    # (sub-dispatches return Q-bucket-padded results) and
                    # cached by that count — the {} dict
                    sp = (
                        [plans[i] for i in idx_or],
                        [plans[i] for i in idx_bool],
                        idx_or,
                        idx_bool,
                        {},
                    )
                else:
                    sp = False
                if len(self._split_cache) > 128:
                    self._split_cache.clear()
                self._split_cache[ck] = sp
            if sp:
                p_or, p_bool, idx_or, idx_bool, invs = sp
                f1 = self.dispatch(p_or, k)
                f2 = self.dispatch(p_bool, k)
                n1p = int(f1.shape[0])
                inv = invs.get(n1p)
                if inv is None:
                    pos = np.empty(
                        len(idx_or) + len(idx_bool), np.int32
                    )
                    pos[idx_or] = np.arange(len(idx_or), dtype=np.int32)
                    pos[idx_bool] = n1p + np.arange(
                        len(idx_bool), dtype=np.int32
                    )
                    inv = jnp.asarray(pos)
                    invs[n1p] = inv
                return _merge_split(f1, f2, inv, k)
            groups = self._cached_partition(plans)
            if groups is not None:
                self.metrics["partitions"].increment()
                outs = []
                for a, b in groups:
                    f = self.dispatch(list(plans[a:b]), k)
                    if f.shape[0] != b - a:  # strip the Q-bucket pad
                        f = f[: b - a]
                    if f.shape[-1] == 2 * k + 1:
                        # exhaustive group: exact by construction — append
                        # a safe=1 column so the fused layouts concatenate
                        f = jnp.concatenate(
                            [f, jnp.ones((f.shape[0], 1), f.dtype)],
                            axis=1,
                        )
                    outs.append(f)
                return jnp.concatenate(outs)
            padded, orig_q = self._pad_batch(plans)
            # PADDED result on purpose: slicing to orig_q in-program
            # made orig_q a static arg of the fused phase-1/2 program,
            # so every novel batch size recompiled it. finalize()/the
            # split merge strip the pad rows on host instead.
            fused = self._dispatch_pruned(padded, k)
            if fused is not None:
                self.metrics["pruned"].increment()
                return fused  # PADDED to the Q bucket; callers slice
            self.metrics["compact_fallbacks"].increment()
        self.metrics["exhaustive"].increment()
        if len(plans) > 1:  # same shape-stability rationale as the
            padded, orig_q = self._pad_batch(plans)  # pruned branch
            return self._exhaustive_chunked(padded, k)[:orig_q]
        return self._exhaustive_chunked(plans, k)

    def _cached_partition(self, plans: Sequence[RowPlan]):
        """Partition decision for a batch, cached by plan identity (the
        per-plan key-set union is Python-side work on the dispatch hot
        path). Only batch-mode pruned dispatches partition — the
        small-batch tile-UB path reads full banks anyway."""
        if len(plans) < 2:
            return None
        ck = tuple(id(p) for p in plans)
        hit = self._part_cache.get(ck)
        if hit is not None:
            return hit[1]
        groups = self._partition_plans(plans)
        if len(self._part_cache) > 256:
            self._part_cache.clear()
        self._part_cache[ck] = (list(plans), groups)  # pin plan ids
        return groups

    def _exhaustive_fused(self, plans: Sequence[RowPlan], k: int):
        """One exhaustive kernel launch for a (chunk of a) batch: the
        pure-OR scan when every plan is pure-OR, else the boolean scan
        (both bit-exact vs the oracle)."""
        args = self._args(plans)
        if all(p.pure_or for p in plans):
            heavy, light, live, hidx, lidx = args[:5]
            return row_score_topk_pure_or(heavy, light, live, hidx, lidx, k=k)
        return row_score_topk(*args, k=k)

    def _exhaustive_chunked(self, plans: Sequence[RowPlan], k: int):
        """Exhaustive scoring with query chunking: an unchunked scan
        carries [Q, D] f32 grids (x4 for booleans) — ~40 GB at Q=1024 on
        a 10M-doc segment. Chunks bound the carry to ~512 MB."""
        D = self.index.num_docs_pad
        per_q = 4 * D * (4 if not all(p.pure_or for p in plans) else 1)
        chunk = max(1, (512 << 20) // per_q)
        if len(plans) <= chunk:
            return self._exhaustive_fused(plans, k)
        outs = []
        for c0 in range(0, len(plans), chunk):
            outs.append(
                self._exhaustive_fused(list(plans[c0 : c0 + chunk]), k)
            )
        return jnp.concatenate(outs)

    def finalize(self, plans: Sequence[RowPlan], fused, k: int):
        """Decode a dispatch() result; escalate pruned queries whose
        exactness certificate failed onto the exhaustive kernel.
        dispatch() may return Q-bucket-PADDED rows (shape-stable device
        programs) — the pad rows are stripped here, on host."""
        from diagon_tpu.search.engine import unfuse_topk

        fused = np.asarray(fused)
        if fused.shape[0] > len(plans):
            fused = fused[: len(plans)]
        if fused.shape[-1] == 2 * k + 1:  # exhaustive layout
            return unfuse_topk(fused, k)
        scores = fused[:, :k].copy()
        docs = fused[:, k : 2 * k].astype(np.int32)
        hits = fused[:, 2 * k].astype(np.int32)
        unsafe = np.nonzero(fused[:, 2 * k + 1] == 0.0)[0]
        if len(unsafe):
            self.metrics["escalations"].increment(len(unsafe))
            # exhaustive escalation materializes [Qe, D] f32 score grids
            # (40 MB/query at 10M docs) — chunk so an escalation burst
            # can't OOM the device
            D = self.index.num_docs_pad
            esc_chunk = max(1, (512 << 20) // (4 * D))
            for c0 in range(0, len(unsafe), esc_chunk):
                grp = unsafe[c0 : c0 + esc_chunk]
                sub = [plans[int(i)] for i in grp]
                if len(sub) > 1:  # shape-stable escalation chunks
                    sub, _ = self._pad_batch(sub)
                sub_fused = self._exhaustive_fused(sub, k)
                s2, d2, h2 = unfuse_topk(
                    np.asarray(sub_fused)[: len(grp)], k
                )
                scores[grp] = s2
                docs[grp] = d2
                hits[grp] = h2
        return scores, docs, hits

    def top_k_batch(self, plans: Sequence[RowPlan], k: int):
        return self.finalize(plans, self.dispatch(plans, k), k)

    def top_k(self, plan: RowPlan, k: int):
        scores, docs, hits = self.top_k_batch([plan], k)
        return scores[0], docs[0], hits[0]

    def count_batch(self, plans: Sequence[RowPlan]) -> np.ndarray:
        args = self._args(plans)
        return np.asarray(row_count(*args))

    def count(self, plan: RowPlan) -> int:
        return int(self.count_batch([plan])[0])
