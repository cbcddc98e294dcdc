"""Segment-sharded search over a device mesh (row-bank engine).

One segment shard per device along mesh axis ``seg``. The full query step —
per-shard row-bank scoring (see ``search/row_engine.py``), local top-k,
cross-device ``all_gather`` of (score, global-docid) pairs, exact
lexicographic merge — is one ``shard_map``-ped jitted program, so XLA
schedules the collective against local compute.

The reference is single-process; its per-leaf loop (``IndexSearcher.cpp:76``)
+ docBase merge is the seam this parallelizes (SURVEY.md section 2.13).
"""

from __future__ import annotations

from functools import partial
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from diagon_tpu.index.segment import SegmentData
from diagon_tpu.ops.approx import bank_rows
from diagon_tpu.search.bm25 import BM25Similarity
from diagon_tpu.search.engine import make_tf_table
from diagon_tpu.search.query import BooleanQuery, Occur, Query, TermQuery
from diagon_tpu.search.row_engine import (
    LANE,
    PRUNE_B0,
    RowFieldIndex,
    _bucket_tq,
)
from diagon_tpu.search.topdocs import ScoreDoc, TopDocs


def merge_topk(scores: jnp.ndarray, docs: jnp.ndarray, k: int):
    """Exact (score desc, docid asc) top-k over the last axis via
    lexicographic two-key sort (32-bit safe)."""
    neg = jnp.negative(scores)
    sorted_neg, sorted_docs = jax.lax.sort(
        (neg, docs), dimension=-1, is_stable=True, num_keys=2
    )
    return -sorted_neg[..., :k], sorted_docs[..., :k]


@partial(jax.jit, static_argnames=("k", "mesh", "axis"))
def _sharded_row_search(
    heavy_banks,  # f32 [S, H_pad, D]
    light_banks,  # f32 [S, L_pad, D]
    live,  # f32 [S, D]
    doc_base,  # int32 [S]
    hidx,  # int32 [S, Q, Tq]
    lidx,  # int32 [S, Q, Tq]
    scoring,  # bool [S, Q, Tq]
    req,
    sho,
    neg,  # f32 [S, Q, Tq]
    bool_params,  # f32 [S, Q, 2]
    *,
    k: int,
    mesh: Mesh,
    axis: str,
):
    def shard_fn(
        heavy_banks, light_banks, live, doc_base,
        hidx, lidx, scoring, req, sho, neg, bool_params,
    ):
        from diagon_tpu.search.row_engine import row_score_topk

        fused = row_score_topk(
            heavy_banks[0],
            light_banks[0],
            live[0],
            hidx[0],
            lidx[0],
            scoring[0],
            req[0],
            sho[0],
            neg[0],
            bool_params[0],
            k=k,
        )  # [Q, 2k+1]
        scores = fused[:, :k]
        docs = fused[:, k : 2 * k].astype(jnp.int32) + doc_base[0]
        hits = fused[:, 2 * k].astype(jnp.int32)

        all_scores = jax.lax.all_gather(scores, axis)  # [S, Q, k]
        all_docs = jax.lax.all_gather(docs, axis)
        S, Q = all_scores.shape[0], scores.shape[0]
        flat_scores = jnp.swapaxes(all_scores, 0, 1).reshape(Q, S * k)
        flat_docs = jnp.swapaxes(all_docs, 0, 1).reshape(Q, S * k)
        m_scores, m_docs = merge_topk(flat_scores, flat_docs, k)
        total_hits = jax.lax.psum(hits, axis)
        return m_scores[None], m_docs[None], total_hits[None]

    specs = [P(axis)] * 11
    f = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=tuple(specs),
        out_specs=(P(axis), P(axis), P(axis)),
        # the scoring kernels init their scan carries with literal zeros
        # (unvarying); skip the varying-manual-axes check
        check_vma=False,
    )
    s, d, h = f(
        heavy_banks, light_banks, live, doc_base,
        hidx, lidx, scoring, req, sho, neg, bool_params,
    )
    return s[0], d[0], h[0]


@partial(jax.jit, static_argnames=("mesh", "axis"))
def _sharded_compact_build(heavy_banks, light_banks, srcidx, *, mesh, axis):
    """Gather each shard's batch-compact bank ON DEVICE from its heavy +
    light banks (``srcidx`` row 0 is the shared zero row, ``1+h`` heavy
    row h, ``1+H+j`` light row j) — the rows are the exact f32 rows the
    exhaustive program reads, so the pruned rescore stays bit-exact by
    construction. Returns the tile-major f32 bank and the bf16 phase-1
    copy (booleans derive presence from it in-kernel), sharded over
    ``axis``."""

    def shard_fn(hb, lb, si):
        D = hb.shape[2]
        src = jnp.concatenate(
            [jnp.zeros((1, D), jnp.float32), hb[0], lb[0]]
        )
        bank = src[si[0]]  # [U8, D]
        U8 = bank.shape[0]
        compact_t = bank.reshape(U8, D // LANE, LANE).transpose(1, 0, 2)
        bf16 = bank.astype(jnp.bfloat16)
        return compact_t[None], bf16[None]

    f = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis)),
        out_specs=(P(axis), P(axis)),
        check_vma=False,
    )
    return f(heavy_banks, light_banks, srcidx)


@partial(
    jax.jit,
    static_argnames=("k", "B", "mesh", "axis", "pure_or", "fused2"),
)
def _sharded_pruned_search(
    compact_t,  # f32 [S, G, U8, LANE]
    compact_bf16,  # bf16 [S, U8, D]
    cidx,  # int32 [S, Q, Tq]
    cflags,  # int32 [S, Q, Tq]
    a_sc_t,  # bf16 [S, U8, Q]
    a_rq_t,
    a_sh_t,
    a_ng_t,
    a_cb_t,  # bf16 [S, U8, Q] combined rq*256+sh (zeros when !fused2)
    params_t,  # f32 [S, 8, Q]
    heavy_banks,  # f32 [S, H_pad, D] (escalation fallback)
    light_banks,  # f32 [S, L_pad, D]
    live,  # f32 [S, D]
    doc_base,  # int32 [S]
    hidx,  # int32 [S, Q, Tq]
    lidx,
    scoring,
    req,
    sho,
    neg,
    bool_params,  # f32 [S, Q, 2]
    *,
    k: int,
    B: int,
    mesh: Mesh,
    axis: str,
    pure_or: bool = False,
    fused2: bool = False,
):
    """Pruned sharded batch search: each shard runs the block-max pruned
    phase 1/2 (``row_score_topk_pruned_batch``) against its LOCAL compact
    bank; queries whose certificate fails escalate to the exhaustive
    kernel via ``lax.cond`` INSIDE the shard program (no host round-trip
    — a per-device data-dependent branch, taken only when some query on
    that shard is uncertified). The merged result is therefore bit-exact
    per shard, and the lexicographic all_gather merge keeps it bit-exact
    globally. Counterpart of the single-chip batch path
    (``RowExecutor._dispatch_pruned``); reference role:
    ``MaxScoreBulkScorer.h:18-120`` per leaf + ``IndexSearcher.cpp:76``."""

    def shard_fn(
        compact_t, compact_bf16, cidx, cflags,
        a_sc_t, a_rq_t, a_sh_t, a_ng_t, a_cb_t, params_t,
        heavy_banks, light_banks, live, doc_base,
        hidx, lidx, scoring, req, sho, neg, bool_params,
    ):
        from diagon_tpu.search.row_engine import (
            row_score_topk,
            row_score_topk_pruned_batch,
        )

        # pure-OR batches take the 1-product phase 1; no-negation boolean
        # batches the fused 2-product kernel; only batches with MUST_NOT
        # (or digit overlap) pay all 4 presence products
        fusedp = row_score_topk_pruned_batch(
            compact_t[0], compact_bf16[0],
            cidx[0], cflags[0], live[0],
            a_sc_t[0], a_rq_t[0], a_sh_t[0], a_ng_t[0], params_t[0],
            bool_params[0], k=k, B=B, boolean=not pure_or,
            a_cb_t=a_cb_t[0] if fused2 else None,
        )  # [Q, 2k+2]
        safe = fusedp[:, 2 * k + 1] > 0
        Q = safe.shape[0]

        def esc(_):
            return row_score_topk(
                heavy_banks[0], light_banks[0], live[0],
                hidx[0], lidx[0], scoring[0], req[0], sho[0], neg[0],
                bool_params[0], k=k,
            )

        fused_ex = jax.lax.cond(
            jnp.all(safe),
            lambda _: jnp.zeros((Q, 2 * k + 1), jnp.float32),
            esc,
            None,
        )
        fused = jnp.where(safe[:, None], fusedp[:, : 2 * k + 1], fused_ex)
        scores = fused[:, :k]
        docs = fused[:, k : 2 * k].astype(jnp.int32) + doc_base[0]
        hits = fused[:, 2 * k].astype(jnp.int32)
        esc_n = jax.lax.psum(
            jnp.sum(jnp.logical_not(safe).astype(jnp.int32)), axis
        )

        all_scores = jax.lax.all_gather(scores, axis)  # [S, Q, k]
        all_docs = jax.lax.all_gather(docs, axis)
        S = all_scores.shape[0]
        flat_scores = jnp.swapaxes(all_scores, 0, 1).reshape(Q, S * k)
        flat_docs = jnp.swapaxes(all_docs, 0, 1).reshape(Q, S * k)
        m_scores, m_docs = merge_topk(flat_scores, flat_docs, k)
        total_hits = jax.lax.psum(hits, axis)
        return (
            m_scores[None],
            m_docs[None],
            total_hits[None],
            esc_n[None],
        )

    specs = [P(axis)] * 21
    f = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=tuple(specs),
        out_specs=(P(axis), P(axis), P(axis), P(axis)),
        check_vma=False,
    )
    s, d, h, e = f(
        compact_t, compact_bf16, cidx, cflags,
        a_sc_t, a_rq_t, a_sh_t, a_ng_t, a_cb_t, params_t,
        heavy_banks, light_banks, live, doc_base,
        hidx, lidx, scoring, req, sho, neg, bool_params,
    )
    return s[0], d[0], h[0], e[0]


class ShardedSearcher:
    """Search across segment shards, one per device on a 1-D mesh."""

    def __init__(self, shards: Sequence[SegmentData], field: str,
                 mesh: Optional[Mesh] = None):
        if mesh is None:
            devs = np.array(jax.devices()[: len(shards)])
            if len(devs) < len(shards):
                raise ValueError(
                    f"{len(shards)} shards but only {len(devs)} devices"
                )
            mesh = Mesh(devs, ("seg",))
        self.mesh = mesh
        self.axis = mesh.axis_names[0]
        self.field = field
        self.shards = list(shards)
        S = len(self.shards)
        if mesh.devices.size != S:
            raise ValueError(
                f"mesh has {mesh.devices.size} devices, need {S}"
            )

        self.doc_bases = np.cumsum([0] + [s.num_docs for s in self.shards])
        self.max_doc = int(self.doc_bases[-1])
        self.sim = BM25Similarity()

        pps = [s.fields[field].postings for s in self.shards]
        self._pps = pps
        stt = sum(pp.sum_total_tf for pp in pps)
        if stt <= 0:
            stt = self.max_doc * 10
        self.avgdl = BM25Similarity.avg_field_length(stt, self.max_doc)
        max_freq = max(
            max(1, int(pp.block_max_freq.max(initial=1))) for pp in pps
        )
        tf_lut_host = make_tf_table(self.avgdl, max_freq)
        self.tf_lut_host = tf_lut_host

        self._idf_cache: Dict[str, np.float32] = {}
        self._phrase_execs: Dict[int, object] = {}

        # per-shard row indexes with a COMMON doc padding (1024 docs = 8
        # tiles, the phase-1 kernel's doc block)
        d_pad = max(
            1024,
            ((max(s.num_docs for s in self.shards) + 1023) // 1024) * 1024,
        )
        self.num_docs_pad = d_pad
        self.row_indexes: List[RowFieldIndex] = []
        for s_ in self.shards:
            fd = s_.fields[field]
            ridx = RowFieldIndex(
                fd.postings, fd.norms, d_pad, s_.live_docs, tf_lut_host
            )
            self.row_indexes.append(ridx)

        # GLOBALLY-ALIGNED heavy banks: the heavy set is chosen by
        # collection df and every shard's bank row j holds the SAME term
        # (zeros where the shard lacks it) — skewed per-shard heavy sets
        # no longer pad each other's banks (round-1 weak point).
        from diagon_tpu.search.row_engine import HEAVY_FRACTION, HEAVY_MIN_DF

        global_df: Dict[str, int] = {}
        for pp in pps:
            for tid, t in enumerate(pp.terms):
                global_df[t] = global_df.get(t, 0) + int(pp.doc_freq[tid])
        threshold = max(HEAVY_MIN_DF, self.max_doc // HEAVY_FRACTION)
        self.heavy_terms = sorted(
            t for t, df_ in global_df.items() if df_ >= threshold
        )
        for si, ridx in enumerate(self.row_indexes):
            pp = pps[si]
            heavy_tids = [pp.term_id(t) for t in self.heavy_terms]
            ridx.build_heavy_bank(
                lambda tid, _pp=pp: self._idf(_pp.terms[tid]),
                heavy_tids=heavy_tids,
            )
        h_pad = max(
            1, max(int(r.heavy_bank.shape[0]) for r in self.row_indexes)
        )
        banks = np.zeros((S, h_pad, d_pad), dtype=np.float32)
        live = np.zeros((S, d_pad), dtype=np.float32)
        for si, ridx in enumerate(self.row_indexes):
            hb = np.asarray(ridx.heavy_bank)
            banks[si, : hb.shape[0]] = hb
            live[si] = np.asarray(ridx.live)
            ridx.heavy_bank = None  # free the per-device copy

        sp = NamedSharding(self.mesh, P(self.axis))
        self.heavy_banks = jax.device_put(jnp.asarray(banks), sp)
        self.live = jax.device_put(jnp.asarray(live), sp)
        self.doc_base = jax.device_put(
            jnp.asarray(self.doc_bases[:-1].astype(np.int32)), sp
        )
        self._plan_cache: Dict[tuple, tuple] = {}

    # ------------------------------------------------------------------
    def term_doc_freq(self, text: str) -> int:
        df = 0
        for pp in self._pps:
            tid = pp.term_id(text)
            if tid >= 0:
                df += int(pp.doc_freq[tid])
        return df

    def _idf(self, text: str, boost: float = 1.0) -> np.float32:
        key = text if boost == 1.0 else f"{text}\0{boost}"
        v = self._idf_cache.get(key)
        if v is None:
            df = self.term_doc_freq(text)
            if df == 0:
                df = max(1, self.max_doc // 10)
            v = np.float32(self.sim.idf(df, self.max_doc) * np.float32(boost))
            self._idf_cache[key] = v
        return v

    _GENERAL = (
        "BooleanQuery", "PhraseQuery", "NumericRangeQuery",
        "PointRangeQuery", "DoubleRangeQuery", "MatchAllDocsQuery",
    )

    def _clauses(self, q: Query) -> Optional[Tuple[list, int]]:
        """Flatten like IndexSearcher._term_clauses: any clause kind is
        accepted (same-field terms as bank rows; everything else compiles
        to host rows via the oracle, see _flat_specs)."""
        if isinstance(q, TermQuery):
            return [(q, Occur.SHOULD)], 1
        if type(q).__name__ in self._GENERAL and not isinstance(
            q, BooleanQuery
        ):
            return [(q, Occur.SHOULD)], 1
        clauses = [(c.query, c.occur) for c in q.clauses]
        min_should = q.minimum_number_should_match
        has_required = any(
            o in (Occur.MUST, Occur.FILTER) for _, o in clauses
        )
        if not has_required:
            min_should = max(min_should, 1)
        has_should = any(o == Occur.SHOULD for _, o in clauses)
        if not has_should and not has_required:
            return None
        return clauses, min_should

    def _oracle_rows(self, si: int, q: Query):
        if getattr(self, "_oracle", None) is None:
            from diagon_tpu.search.oracle import OracleSearcher

            self._oracle = OracleSearcher(self.shards)
        scores, mask = self._oracle._score_dense(self.shards[si], q)
        return scores, mask.astype(np.float32)

    def _phrase_rows(self, si: int, q) -> Optional[tuple]:
        """Phrase clause rows via the DEVICE position-intersection kernel
        (the same PhraseExecutor the single-chip searcher uses — the
        numpy oracle costs ~9-51 s per phrase clause at 1M docs). Returns
        None (-> oracle fallback) for foreign fields or positionless
        shards; scores are bit-identical to the oracle's."""
        if q.field != self.field:
            return None
        ex = self._phrase_execs.get(si, False)
        if ex is False:
            try:
                from diagon_tpu.search.device_index import load_segment
                from diagon_tpu.search.phrase import PhraseExecutor

                ds = load_segment(self.shards[si])
                ex = PhraseExecutor(ds, self.field,
                                    jnp.asarray(self.tf_lut_host))
            except (ValueError, KeyError):
                ex = None
            self._phrase_execs[si] = ex
        if ex is None:
            return None
        # idf from the rarest member term over GLOBAL stats, mirroring
        # OracleSearcher._score_phrase (PhraseQuery.cpp:304-338)
        min_df = self.max_doc
        for t in q.terms:
            df = self.term_doc_freq(t)
            if df > 0:
                min_df = min(min_df, df)
        if min_df <= 0:
            min_df = 1
        idf = float(
            self.sim.idf(min_df, self.max_doc) * np.float32(q.boost)
        )
        return ex.score_row(q.terms, idf, self.shards[si].num_docs)

    def _flat_specs(self, si: int, clauses, min_should):
        """One shard's flat clause specs in oracle order:
        (hterm_row, host_row, weight, scoring, is_req, is_sho, is_neg)."""
        from diagon_tpu.search.oracle import (
            double_range_mask,
            numeric_range_mask,
            point_range_mask,
        )
        from diagon_tpu.search.query import (
            DoubleRangeQuery,
            MatchAllDocsQuery,
            NumericRangeQuery,
            PointRangeQuery,
        )

        pp = self._pps[si]
        ridx = self.row_indexes[si]
        seg = self.shards[si]

        def _key(item):
            q = item[0]
            return (
                (q.term.field, q.term.text)
                if isinstance(q, TermQuery)
                else ("", "")
            )

        groups = [
            (sorted([c for c in clauses if c[1] == o], key=_key), o)
            for o in (Occur.MUST, Occur.FILTER, Occur.SHOULD, Occur.MUST_NOT)
        ]
        num_required = sum(
            len(g) for g, o in groups if o in (Occur.MUST, Occur.FILTER)
        )
        specs = []  # (hrow, host_row, weight, scoring, req, sho, neg)
        for group, occ in groups:
            is_req = occ in (Occur.MUST, Occur.FILTER)
            is_sho = occ == Occur.SHOULD
            is_neg = occ == Occur.MUST_NOT
            scoring = occ in (Occur.MUST, Occur.SHOULD)
            for q, _ in group:
                if isinstance(q, TermQuery) and q.term.field == self.field:
                    tid = pp.term_id(q.term.text)
                    if tid < 0:
                        specs.append(
                            (-1, None, 0.0, False, is_req, is_sho, is_neg)
                        )
                        continue
                    w = self._idf(q.term.text, q.boost)
                    hrow = (
                        int(ridx.heavy_row_of_term[tid])
                        if ridx.heavy_row_of_term is not None
                        else -1
                    )
                    if hrow >= 0 and (
                        not scoring
                        or np.float32(w) == self._idf(q.term.text)
                    ):
                        specs.append(
                            (hrow, None, float(w), scoring,
                             is_req, is_sho, is_neg)
                        )
                    else:
                        ww = np.float32(w) if scoring else np.float32(1.0)
                        specs.append(
                            (-1, ridx.host_row(tid, ww), float(ww),
                             scoring, is_req, is_sho, is_neg)
                        )
                    continue
                if isinstance(
                    q, (NumericRangeQuery, PointRangeQuery,
                        DoubleRangeQuery, MatchAllDocsQuery)
                ):
                    if isinstance(q, MatchAllDocsQuery):
                        row = np.ones(seg.num_docs, np.float32)
                    elif isinstance(q, NumericRangeQuery):
                        row = numeric_range_mask(
                            seg, q.field, q.lower, q.upper
                        ).astype(np.float32)
                    elif isinstance(q, DoubleRangeQuery):
                        row = double_range_mask(
                            seg, q.field, q.lower, q.upper,
                            q.include_lower, q.include_upper,
                        ).astype(np.float32)
                    else:
                        row = point_range_mask(
                            seg, q.field, q.lower, q.upper
                        ).astype(np.float32)
                    specs.append(
                        (-1, row, 1.0 if scoring else 0.0, scoring,
                         is_req, is_sho, is_neg)
                    )
                    continue
                from diagon_tpu.search.query import PhraseQuery

                pr = (
                    self._phrase_rows(si, q)
                    if isinstance(q, PhraseQuery)
                    else None
                )
                scores, match = (
                    pr if pr is not None else self._oracle_rows(si, q)
                )
                if isinstance(q, BooleanQuery):
                    if scoring:
                        specs.append(
                            (-1, scores, 1.0, True, False, False, False)
                        )
                    specs.append(
                        (-1, match, 0.0, False, is_req, is_sho, is_neg)
                    )
                else:  # phrase / foreign-field term: score>0 iff matched
                    row = scores if scoring else match
                    specs.append(
                        (-1, row, 1.0 if scoring else 0.0, scoring,
                         is_req, is_sho, is_neg)
                    )
        return specs, num_required

    def _plans(self, queries: Sequence[Query]):
        """Stacked per-shard plan arrays, sharded over the mesh."""
        key = tuple(repr(q) for q in queries)
        cached = self._plan_cache.get(key)
        if cached is not None:
            return cached

        S = len(self.shards)
        Q = len(queries)
        per_query = []
        for q in queries:
            c = self._clauses(q)
            if c is None:
                raise ValueError(
                    f"ShardedSearcher: query matches nothing ({q!r})"
                )
            per_query.append(c)

        # compile every (query, shard) spec list first: A/B splits make
        # the clause count query-dependent
        all_specs = [
            [
                self._flat_specs(si, clauses, min_should)
                for si in range(S)
            ]
            for clauses, min_should in per_query
        ]
        tq = _bucket_tq(
            max(
                len(specs)
                for per_shard in all_specs
                for specs, _ in per_shard
            )
        )

        hidx = np.full((S, Q, tq), -1, dtype=np.int32)
        lidx = np.zeros((S, Q, tq), dtype=np.int32)
        scoring = np.zeros((S, Q, tq), dtype=bool)
        req = np.zeros((S, Q, tq), dtype=np.float32)
        sho = np.zeros((S, Q, tq), dtype=np.float32)
        neg = np.zeros((S, Q, tq), dtype=np.float32)
        bool_params = np.zeros((S, Q, 2), dtype=np.float32)
        light_rows: List[List[np.ndarray]] = [[] for _ in range(S)]

        for qi, (clauses_ms, per_shard) in enumerate(
            zip(per_query, all_specs)
        ):
            _, min_should = clauses_ms
            for si in range(S):
                specs, num_required = per_shard[si]
                for i, (
                    hrow, host_row, w, sc, is_req, is_sho, is_neg
                ) in enumerate(specs):
                    present = hrow >= 0 or host_row is not None
                    scoring[si, qi, i] = sc and w != 0.0
                    req[si, qi, i] = 1.0 if (is_req and present) else 0.0
                    sho[si, qi, i] = 1.0 if (is_sho and present) else 0.0
                    neg[si, qi, i] = 1.0 if (is_neg and present) else 0.0
                    if hrow >= 0:
                        hidx[si, qi, i] = hrow
                    elif host_row is not None:
                        padded = np.zeros(self.num_docs_pad, np.float32)
                        padded[: len(host_row)] = host_row
                        light_rows[si].append(padded)
                        lidx[si, qi, i] = len(light_rows[si])
                bool_params[si, qi] = (num_required, min_should)

        l_pad = max(1, max(len(r) for r in light_rows) + 1)
        l_pad = 1 << int(np.ceil(np.log2(l_pad)))
        lbanks = np.zeros((S, l_pad, self.num_docs_pad), dtype=np.float32)
        for si in range(S):
            for j, row in enumerate(light_rows[si]):
                lbanks[si, j + 1] = row

        sp = NamedSharding(self.mesh, P(self.axis))
        out = tuple(
            jax.device_put(jnp.asarray(a), sp)
            for a in (lbanks, hidx, lidx, scoring, req, sho, neg, bool_params)
        )
        compact = self._compact_plans(
            hidx, lidx, scoring, req, sho, neg, bool_params,
            [len(r) for r in light_rows], sp=sp,
        )
        if compact is not None:
            ct, cbf16 = _sharded_compact_build(
                self.heavy_banks, out[0], compact["srcidx"],
                mesh=self.mesh, axis=self.axis,
            )
            compact["compact_t"] = ct
            compact["compact_bf16"] = cbf16
        out = out + (compact,)
        if len(self._plan_cache) < 64:
            self._plan_cache[key] = out
        return out

    # batches at least this large take the pruned per-shard kernels (the
    # single-chip RowExecutor.approx_min_q); below it the exhaustive
    # program wins (one bank pass, no certificate risk)
    approx_min_q = 8
    COMPACT_MAX_ROWS = 512
    # tests force a tiny tile budget to exercise the in-program escalation
    prune_B_override: int = 0

    def _compact_plans(self, hidx, lidx, scoring, req, sho, neg,
                       bool_params, n_light, *, sp):
        """Host-side compact-plan arrays for the pruned sharded program
        (None when the batch shouldn't/can't prune). Mirrors
        ``RowExecutor._build_compact`` per shard: each shard's clause rows
        compact into ``srcidx`` gather indices (resolved on device by
        ``_sharded_compact_build``) with per-clause indices remapped."""
        S, Q, Tq = hidx.shape
        if Q < self.approx_min_q:
            return None
        H_pad = int(self.heavy_banks.shape[1])
        used = [np.unique(hidx[si][hidx[si] >= 0]) for si in range(S)]
        maxU = max(1 + len(used[si]) + n_light[si] for si in range(S))
        if maxU > self.COMPACT_MAX_ROWS:
            return None
        U8 = bank_rows(maxU)
        srcidx = np.zeros((S, U8), np.int32)
        cidx = np.zeros((S, Q, Tq), np.int32)
        a = {
            r: np.zeros((S, U8, Q), np.float32)
            for r in ("sc", "rq", "sh", "ng")
        }
        qgrid = np.broadcast_to(np.arange(Q)[:, None], (Q, Tq))
        for si in range(S):
            u = used[si]
            nl = n_light[si]
            srcidx[si, 1 : 1 + len(u)] = 1 + u
            srcidx[si, 1 + len(u) : 1 + len(u) + nl] = (
                1 + H_pad + 1 + np.arange(nl)
            )
            hpos = np.zeros(int(u.max()) + 1 if len(u) else 1, np.int32)
            hpos[u] = 1 + np.arange(len(u), dtype=np.int32)
            cidx[si] = np.where(
                hidx[si] >= 0,
                hpos[np.maximum(hidx[si], 0)],
                np.where(lidx[si] > 0, 1 + len(u) + (lidx[si] - 1), 0),
            ).astype(np.int32)
            for r, marr in (
                ("sc", scoring[si]),
                ("rq", req[si] > 0),
                ("sh", sho[si] > 0),
                ("ng", neg[si] > 0),
            ):
                m = marr.astype(bool) & (cidx[si] > 0)
                np.add.at(a[r][si], (cidx[si][m], qgrid[m]), 1.0)
        cflags = (
            scoring.astype(np.int32)
            + 2 * (req > 0).astype(np.int32)
            + 4 * (sho > 0).astype(np.int32)
            + 8 * (neg > 0).astype(np.int32)
        )
        params = np.zeros((S, 8, Q), np.float32)
        params[:, 0] = bool_params[:, :, 0]
        params[:, 1] = bool_params[:, :, 1]

        # kernel-variant selection (mirrors the single-chip dispatch):
        # pure-OR -> 1-product phase 1; no-negation boolean without
        # role-overlapping rows -> fused 2-product; else 4-product
        present_nonscoring = ((cidx > 0) & ~scoring.astype(bool)).any()
        pure_or = bool(
            not (req > 0).any()
            and not (neg > 0).any()
            and bool_params[:, :, 1].max(initial=0) <= 1
            and not present_nonscoring
        )
        fused2 = bool(
            not pure_or
            and not a["ng"].any()
            and not ((a["rq"] > 0) & (a["sh"] > 0)).any()
            and a["rq"].max(initial=0) < 256
        )

        def put(arr, dtype=None):
            j = jnp.asarray(arr)
            if dtype is not None:
                j = j.astype(dtype)
            return jax.device_put(j, sp)

        return {
            "srcidx": put(srcidx),
            "cidx": put(cidx),
            "cflags": put(cflags),
            "a_sc_t": put(a["sc"], jnp.bfloat16),
            "a_rq_t": put(a["rq"], jnp.bfloat16),
            "a_sh_t": put(a["sh"], jnp.bfloat16),
            "a_ng_t": put(a["ng"], jnp.bfloat16),
            "a_cb_t": put(
                a["rq"] * np.float32(256.0) + a["sh"], jnp.bfloat16
            ),
            "params_t": put(params),
            "pure_or": pure_or,
            "fused2": fused2,
        }

    # ------------------------------------------------------------------
    def search_batch(self, queries: Sequence[Query], k: int = 10) -> List[TopDocs]:
        (
            lbanks, hidx, lidx, scoring, req, sho, neg, bool_params, compact,
        ) = self._plans(queries)
        if compact is not None:
            G = self.num_docs_pad // LANE
            B = self.prune_B_override or min(
                G, max(PRUNE_B0, -(-k // LANE) + 1, G // 512)
            )
            scores, docs, hits, esc_n = _sharded_pruned_search(
                compact["compact_t"],
                compact["compact_bf16"],
                compact["cidx"],
                compact["cflags"],
                compact["a_sc_t"],
                compact["a_rq_t"],
                compact["a_sh_t"],
                compact["a_ng_t"],
                compact["a_cb_t"],
                compact["params_t"],
                self.heavy_banks,
                lbanks,
                self.live,
                self.doc_base,
                hidx,
                lidx,
                scoring,
                req,
                sho,
                neg,
                bool_params,
                k=k,
                B=B,
                mesh=self.mesh,
                axis=self.axis,
                pure_or=compact["pure_or"],
                fused2=compact["fused2"],
            )
            n_esc = int(np.asarray(esc_n))
            if n_esc:
                from diagon_tpu.observability.metrics import registry

                registry.counter(
                    "search.sharded_escalations",
                    "sharded (query, shard) pairs escalated to exhaustive",
                ).increment(n_esc)
        else:
            scores, docs, hits = _sharded_row_search(
                self.heavy_banks,
                lbanks,
                self.live,
                self.doc_base,
                hidx,
                lidx,
                scoring,
                req,
                sho,
                neg,
                bool_params,
                k=k,
                mesh=self.mesh,
                axis=self.axis,
            )
        scores = np.asarray(scores)
        docs = np.asarray(docs)
        hits = np.asarray(hits)
        out = []
        for qi in range(len(queries)):
            n = int(hits[qi])
            sds = [
                ScoreDoc(int(d), float(s))
                for s, d in zip(scores[qi], docs[qi])
                if s >= 0.0
            ][:n]
            out.append(TopDocs(n, sds))
        return out

    def search(self, query: Query, k: int = 10) -> TopDocs:
        return self.search_batch([query], k)[0]
