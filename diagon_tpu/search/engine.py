"""Block-at-a-time device query engine.

This replaces the reference's entire Weight/Scorer/BulkScorer iterator stack
(``search/WANDScorer.h``, ``MaxScoreBulkScorer.h``, ``BooleanQuery.cpp``)
with one data-parallel plan:

1. **Host plan** (microseconds): look up each query term in the host term
   dict, compute its float32 idf (exact reference formula), and emit flat
   per-block arrays: the block ids of every candidate block plus the owning
   clause's weight and MUST/SHOULD/MUST_NOT flags. Padded to a power-of-two
   bucket so XLA compiles once per bucket size.

2. **Device kernel** (one fused XLA program): gather block windows from the
   packed word stream, bit-unpack doc deltas + freqs for all 128 lanes of
   all blocks at once, prefix-sum deltas into absolute docids, gather norms,
   compute BM25 for every (block, lane), and scatter-add a 4-column payload
   (score, must-count, should-count, not-count) into a dense per-doc
   accumulator. Boolean semantics become three vectorized comparisons on the
   count columns; ``lax.top_k`` (ties -> lower docid, matching the
   reference collector's ordering) yields the final hits.

Every float op mirrors ``BM25Similarity.h`` bit-for-bit; accumulation order
is block order = ascending term order, the same order the numpy oracle uses.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from diagon_tpu.ops.bitpack_ops import decode_doc_blocks
from diagon_tpu.search.bm25 import BM25Similarity
from diagon_tpu.search.device_index import DeviceField, DeviceSegment


def _bucket(n: int, minimum: int = 16) -> int:
    """Round up to a power of two to bound jit recompiles."""
    return max(minimum, 1 << math.ceil(math.log2(max(1, n))))


@dataclass
class TermPlan:
    """Scored/flagged clause for one segment.

    Either a posting term (``term_id`` >= 0) or a precomputed host row
    (``host_row`` set: used for range / match-all clauses, whose dense
    indicator-score row is built from doc values or points on the host).
    """

    term_id: int
    weight: float  # idf * boost; 0.0 for FILTER / MUST_NOT clauses
    required: bool = False  # MUST or FILTER
    should: bool = False
    negated: bool = False
    host_row: object = None  # optional np.ndarray [num_docs_pad] f32


@dataclass
class SegmentPlan:
    """Flat per-block device arrays for one segment (padded)."""

    blocks: np.ndarray  # int32 [B_pad]; -1 = padding
    weight: np.ndarray  # f32  [B_pad]
    req: np.ndarray  # f32  [B_pad] 1.0 if required clause
    sho: np.ndarray  # f32  [B_pad]
    neg: np.ndarray  # f32  [B_pad]
    num_required: int
    min_should: int
    inv_avgdl: float

    @property
    def b_pad(self) -> int:
        return len(self.blocks)


def build_segment_plan(
    field: DeviceField,
    terms: Sequence[TermPlan],
    min_should: int,
    inv_avgdl: float,
    bucket_min: int = 16,
) -> SegmentPlan:
    blocks_l: List[np.ndarray] = []
    weight_l: List[np.ndarray] = []
    req_l: List[np.ndarray] = []
    sho_l: List[np.ndarray] = []
    neg_l: List[np.ndarray] = []

    num_required = 0
    for tp in terms:
        if tp.required:
            num_required += 1
        if tp.term_id < 0:
            continue
        bs = int(field.block_start[tp.term_id])
        be = int(field.block_start[tp.term_id + 1])
        nb = be - bs
        if nb == 0:
            continue
        blocks_l.append(np.arange(bs, be, dtype=np.int32))
        weight_l.append(np.full(nb, tp.weight, dtype=np.float32))
        req_l.append(np.full(nb, 1.0 if tp.required else 0.0, dtype=np.float32))
        sho_l.append(np.full(nb, 1.0 if tp.should else 0.0, dtype=np.float32))
        neg_l.append(np.full(nb, 1.0 if tp.negated else 0.0, dtype=np.float32))

    B = sum(len(b) for b in blocks_l)
    b_pad = _bucket(B, bucket_min)

    def cat(parts, dtype, fill):
        out = np.full(b_pad, fill, dtype=dtype)
        if parts:
            v = np.concatenate(parts)
            out[: len(v)] = v
        return out

    return SegmentPlan(
        blocks=cat(blocks_l, np.int32, -1),
        weight=cat(weight_l, np.float32, 0.0),
        req=cat(req_l, np.float32, 0.0),
        sho=cat(sho_l, np.float32, 0.0),
        neg=cat(neg_l, np.float32, 0.0),
        num_required=num_required,
        min_should=min_should,
        inv_avgdl=inv_avgdl,
    )


# ---------------------------------------------------------------------------
# Device kernels
# ---------------------------------------------------------------------------


def make_tf_table(avgdl: np.float32, max_freq: int,
                  k1: float = 1.2, b: float = 0.75) -> np.ndarray:
    """Host-precomputed ``freq/(freq + k(norm))`` factor, f32 [128*(F)].

    BM25 per-posting score is ``idf * freq/(freq + k)`` where ``k`` depends
    only on the norm byte and ``avgdl``. Precomputing the freq/norm factor
    on the host (numpy float32, exactly the oracle's arithmetic) reduces the
    device hot loop to one gather + one multiply — no division, whose device
    implementation is not guaranteed correctly-rounded, so this is both the
    fast path AND the bit-exactness guarantee.

    Layout: row-major [norm (128), freq (max_freq+1)]; freq 0 -> 0.0.
    """
    F = max_freq + 1
    sim = BM25Similarity(k1, b)
    scorer = sim.scorer(np.float32(1.0), np.float32(avgdl))
    norms = np.repeat(np.arange(128, dtype=np.int32), F)
    freqs = np.tile(np.arange(F, dtype=np.float32), 128)
    table = scorer.score(freqs, norms).astype(np.float32)
    table[freqs == 0] = 0.0
    return table


def _block_contribs(
    packed,
    block_base,
    block_count,
    block_doc_bits,
    block_freq_bits,
    block_word_off,
    norms,
    tf_lut,  # f32 [128 * F] host-precomputed freq/(freq+k(norm)) factors
    blocks,
    weight,
    *,
    window_words: int,
):
    """Decode + BM25-score the selected blocks.

    Returns (docids i32 [B,128], contrib f32 [B,128], valid bool [B,128]).
    """
    bsel = jnp.maximum(blocks, 0)
    docids, freqs, valid = decode_doc_blocks(
        packed,
        block_word_off[bsel],
        block_base[bsel],
        block_count[bsel],
        block_doc_bits[bsel],
        block_freq_bits[bsel],
        window_words=window_words,
    )
    valid = valid & (blocks >= 0)[:, None]

    num_docs_pad = norms.shape[0]
    docc = jnp.clip(docids, 0, num_docs_pad - 1)
    norm = norms[docc]

    F = tf_lut.shape[0] // 128
    lut_idx = norm * F + jnp.clip(freqs, 0, F - 1)
    tf_factor = tf_lut[lut_idx]
    contrib = weight[:, None] * tf_factor
    contrib = jnp.where(valid, contrib, jnp.float32(0.0))
    return docids, contrib, valid


@partial(jax.jit, static_argnames=("window_words", "k"))
def score_and_topk(
    packed,
    block_base,
    block_count,
    block_doc_bits,
    block_freq_bits,
    block_word_off,
    norms,
    tf_lut,
    live_mask,  # f32 [num_docs_pad]: 1.0 live, 0.0 deleted/padding
    blocks,  # int32 [B_pad]
    weight,  # f32 [B_pad]
    req,
    sho,
    neg,  # f32 [B_pad]
    bool_params,  # f32 [2]: num_required, min_should
    *,
    window_words: int,
    k: int,
):
    """Full boolean scoring -> (top-k scores, top-k docids, total hits)."""
    docids, contrib, valid = _block_contribs(
        packed,
        block_base,
        block_count,
        block_doc_bits,
        block_freq_bits,
        block_word_off,
        norms,
        tf_lut,
        blocks,
        weight,
        window_words=window_words,
    )
    num_docs_pad = norms.shape[0]

    validf = valid.astype(jnp.float32)
    payload = jnp.stack(
        [
            contrib,
            req[:, None] * validf,
            sho[:, None] * validf,
            neg[:, None] * validf,
        ],
        axis=-1,
    )  # [B,128,4]

    sidx = jnp.where(valid, docids, num_docs_pad).reshape(-1)
    acc = jnp.zeros((num_docs_pad + 1, 4), dtype=jnp.float32)
    acc = acc.at[sidx].add(payload.reshape(-1, 4), mode="drop")
    acc = acc[:num_docs_pad]

    scores = acc[:, 0]
    req_cnt = acc[:, 1]
    sho_cnt = acc[:, 2]
    neg_cnt = acc[:, 3]

    num_required = bool_params[0]
    min_should = bool_params[1]
    mask = (
        (req_cnt == num_required)
        & (sho_cnt >= min_should)
        & (neg_cnt == 0)
        & ((req_cnt + sho_cnt) > 0)
        & (live_mask > 0)
    )

    final = jnp.where(mask, scores, jnp.float32(-1.0))
    top_scores, top_docs = jax.lax.top_k(final, k)
    hits = jnp.sum(mask.astype(jnp.int32))
    # Fuse into one f32 vector [2k+1] so the host needs a single
    # device->host readback per call. Docids/hit counts are carried as
    # exact f32 VALUES (exact below 2^24) — NOT bitcast patterns, which
    # would be denormals for small ints and get flushed to zero by a
    # flush-to-zero mode.
    fused = jnp.concatenate(
        [
            top_scores,
            top_docs.astype(jnp.float32),
            hits[None].astype(jnp.float32),
        ]
    )
    return fused


def unfuse_topk(fused: np.ndarray, k: int):
    """Host-side decode of the fused kernel output -> (scores, docs, hits)."""
    fused = np.asarray(fused)
    scores = fused[..., :k]
    docs = fused[..., k : 2 * k].astype(np.int32)
    hits = fused[..., 2 * k].astype(np.int32)
    return scores, docs, hits


def unfuse_topk_device(fused: jnp.ndarray, k: int):
    """Device-side decode (for composing into larger programs)."""
    scores = fused[..., :k]
    docs = fused[..., k : 2 * k].astype(jnp.int32)
    hits = fused[..., 2 * k].astype(jnp.int32)
    return scores, docs, hits


@partial(jax.jit, static_argnames=("window_words",))
def count_matches(
    packed,
    block_base,
    block_count,
    block_doc_bits,
    block_freq_bits,
    block_word_off,
    norms,
    tf_lut,
    live_mask,
    blocks,
    weight,
    req,
    sho,
    neg,
    bool_params,
    *,
    window_words: int,
):
    """Match count only (reference Weight::count / TotalHitCountCollector)."""
    docids, _, valid = _block_contribs(
        packed,
        block_base,
        block_count,
        block_doc_bits,
        block_freq_bits,
        block_word_off,
        norms,
        tf_lut,
        blocks,
        weight,
        window_words=window_words,
    )
    num_docs_pad = norms.shape[0]
    validf = valid.astype(jnp.float32)
    payload = jnp.stack(
        [req[:, None] * validf, sho[:, None] * validf, neg[:, None] * validf],
        axis=-1,
    )
    sidx = jnp.where(valid, docids, num_docs_pad).reshape(-1)
    acc = jnp.zeros((num_docs_pad + 1, 3), dtype=jnp.float32)
    acc = acc.at[sidx].add(payload.reshape(-1, 3), mode="drop")
    acc = acc[:num_docs_pad]
    mask = (
        (acc[:, 0] == bool_params[0])
        & (acc[:, 1] >= bool_params[1])
        & (acc[:, 2] == 0)
        & ((acc[:, 0] + acc[:, 1]) > 0)
        & (live_mask > 0)
    )
    return jnp.sum(mask.astype(jnp.int32))


@partial(jax.jit, static_argnames=("window_words", "k"))
def score_and_topk_batch(
    packed,
    block_base,
    block_count,
    block_doc_bits,
    block_freq_bits,
    block_word_off,
    norms,
    tf_lut,
    live_mask,
    blocks,  # int32 [Q, B_pad] — a batch of Q query plans
    weight,  # f32  [Q, B_pad]
    req,
    sho,
    neg,  # f32  [Q, B_pad]
    bool_params,  # f32 [Q, 2]
    *,
    window_words: int,
    k: int,
):
    """Batched-query scoring: vmap of ``score_and_topk`` over the plan axis.

    This is where the accelerator wins its throughput: Q queries share one
    fused program, the per-query scatter/top-k units pipeline across the
    batch, and host<->device round-trips amortize Q-fold. Returns the fused
    [Q, 2k+1] output (see ``unfuse_topk``).
    """
    f = partial(score_and_topk, window_words=window_words, k=k)
    return jax.vmap(
        lambda b, w, r, s, n, p: f(
            packed,
            block_base,
            block_count,
            block_doc_bits,
            block_freq_bits,
            block_word_off,
            norms,
            tf_lut,
            live_mask,
            b,
            w,
            r,
            s,
            n,
            p,
        )
    )(blocks, weight, req, sho, neg, bool_params)


# ---------------------------------------------------------------------------
# Segment executor
# ---------------------------------------------------------------------------

BM25_K1 = np.float32(1.2)
BM25_B = np.float32(0.75)


class SegmentExecutor:
    """Runs compiled plans against one device segment + field.

    ``tf_lut`` is collection-level (avgdl spans all segments), so it is
    supplied by the searcher rather than derived from the segment.
    """

    def __init__(self, segment: DeviceSegment, field_name: str, tf_lut):
        self.segment = segment
        self.field = segment.field(field_name)
        self.tf_lut = tf_lut
        # batched-plan device-array cache (keyed by plan identities; holds
        # strong refs to the plans so ids stay valid)
        self._batch_cache: Dict[tuple, tuple] = {}
        live = segment.live_docs
        if live is None:
            lm = np.zeros(segment.num_docs_pad, dtype=np.float32)
            lm[: segment.num_docs] = 1.0
            self.live_mask = jnp.asarray(lm)
        else:
            self.live_mask = live.astype(jnp.float32)

    def _index_args(self):
        f = self.field
        return (
            f.packed,
            f.block_base,
            f.block_count,
            f.block_doc_bits,
            f.block_freq_bits,
            f.block_word_off,
            f.norms,
            self.tf_lut,
            self.live_mask,
        )

    def _plan_args(self, plan: SegmentPlan):
        # Memoize the device copies on the plan (plans are immutable and
        # cached by the searcher, so repeated queries skip the uploads).
        dev = getattr(plan, "_dev_args", None)
        if dev is None:
            dev = (
                jnp.asarray(plan.blocks),
                jnp.asarray(plan.weight),
                jnp.asarray(plan.req),
                jnp.asarray(plan.sho),
                jnp.asarray(plan.neg),
                jnp.asarray(
                    [plan.num_required, plan.min_should], dtype=jnp.float32
                ),
            )
            plan._dev_args = dev
        return dev

    def top_k(self, plan: SegmentPlan, k: int):
        fused = score_and_topk(
            *self._index_args(),
            *self._plan_args(plan),
            window_words=self.field.window_words,
            k=k,
        )
        return unfuse_topk(fused, k)

    def count(self, plan: SegmentPlan) -> int:
        return int(
            count_matches(
                *self._index_args(),
                *self._plan_args(plan),
                window_words=self.field.window_words,
            )
        )

    def top_k_batch(self, plans: Sequence[SegmentPlan], k: int):
        """Run Q plans in one device program -> ([Q,k], [Q,k], [Q])."""
        cache_key = tuple(id(p) for p in plans)
        cached = self._batch_cache.get(cache_key)
        if cached is not None:
            plan_refs, dev_args = cached
            fused = score_and_topk_batch(
                *self._index_args(),
                *dev_args,
                window_words=self.field.window_words,
                k=k,
            )
            return unfuse_topk(fused, k)
        b_pad = _bucket(max(p.b_pad for p in plans))

        def stack(get, fill, dtype):
            out = np.full((len(plans), b_pad), fill, dtype=dtype)
            for i, p in enumerate(plans):
                v = get(p)
                out[i, : len(v)] = v
            return jnp.asarray(out)

        blocks = stack(lambda p: p.blocks, -1, np.int32)
        weight = stack(lambda p: p.weight, 0.0, np.float32)
        req = stack(lambda p: p.req, 0.0, np.float32)
        sho = stack(lambda p: p.sho, 0.0, np.float32)
        neg = stack(lambda p: p.neg, 0.0, np.float32)
        bool_params = jnp.asarray(
            [[p.num_required, p.min_should] for p in plans], dtype=jnp.float32
        )
        dev_args = (blocks, weight, req, sho, neg, bool_params)
        if len(self._batch_cache) < 64:
            self._batch_cache[cache_key] = (list(plans), dev_args)
        fused = score_and_topk_batch(
            *self._index_args(),
            *dev_args,
            window_words=self.field.window_words,
            k=k,
        )
        return unfuse_topk(fused, k)
