"""IndexSearcher: host orchestration of device query execution.

The equivalent of the reference's ``IndexSearcher`` + Weight tree
(``IndexSearcher.cpp:50-141``), redesigned: instead of a per-leaf iterator
loop, each segment gets a flat device plan; per-segment device top-k results
merge by (score desc, global docid asc) — the same ordering the reference's
``TopScoreDocCollector`` produces.

Query routing:

- TermQuery / BooleanQuery over term clauses -> block-scoring kernel
  (``engine.py``).
- PhraseQuery -> device conjunction + position-intersection kernel
  (``phrase.py``).
- MatchAll / range queries and nested boolean trees -> scalar fallback on
  the host segment copy (these are cheap metadata scans; device granule
  kernels for columnar ranges live in ``diagon_tpu/columnar``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import jax.numpy as jnp
import numpy as np

from diagon_tpu.index.segment import SegmentData
from diagon_tpu.search.bm25 import BM25Similarity
from diagon_tpu.search.device_index import (
    DeviceSegment,
    collection_stats,
    load_segment,
)
from diagon_tpu.search.engine import (
    SegmentExecutor,
    SegmentPlan,
    TermPlan,
    build_segment_plan,
    make_tf_table,
)
from diagon_tpu.search.query import (
    BooleanQuery,
    MatchAllDocsQuery,
    DoubleRangeQuery,
    NumericRangeQuery,
    Occur,
    PhraseQuery,
    PointRangeQuery,
    Query,
    TermQuery,
)
from diagon_tpu.search.topdocs import ScoreDoc, TopDocs, merge_top_docs


class _FieldContext:
    """Collection-level scoring state for one field."""

    def __init__(self, searcher: "IndexSearcher", field: str):
        self.field = field
        # Collection stats come from the HOST segments so they are
        # residency-independent (tier-managed searchers may have segments
        # demoted off-device at any time).
        host_segs = searcher._host_segments()
        stt = 0
        max_freq = 1
        for seg in host_segs:
            fd = seg.fields.get(field)
            if fd is not None:
                if fd.postings.sum_total_tf > 0:
                    stt += fd.postings.sum_total_tf
                if fd.postings.num_blocks:
                    max_freq = max(
                        max_freq, int(fd.postings.block_max_freq.max())
                    )
        if stt <= 0:
            stt = searcher.max_doc * 10
        from diagon_tpu.search.bm25 import BM25Similarity

        self.avgdl = BM25Similarity.avg_field_length(stt, searcher.max_doc)
        self.tf_lut_host = make_tf_table(self.avgdl, max_freq)
        self.tf_lut = jnp.asarray(self.tf_lut_host)
        self.executors = [None] * len(searcher.device_segments)
        self.row_executors = [None] * len(searcher.device_segments)
        for si in range(len(searcher.device_segments)):
            self.rebuild_segment(searcher, si)

    def rebuild_segment(self, searcher: "IndexSearcher", si: int) -> None:
        """(Re)build this field's executors for one (resident) segment —
        also the tier-promotion hook."""
        ds = searcher.device_segments[si]
        if ds is None or self.field not in ds.fields:
            self.executors[si] = None
            self.row_executors[si] = None
            return
        self.executors[si] = SegmentExecutor(ds, self.field, self.tf_lut)
        from diagon_tpu.search.row_engine import RowExecutor, RowFieldIndex

        if ds.source is None:
            self.row_executors[si] = None
            return
        fd = ds.source.fields[self.field]
        ridx = RowFieldIndex(
            fd.postings,
            fd.norms,
            ds.num_docs_pad,
            ds.source.live_docs,
            self.tf_lut_host,
        )
        pp = fd.postings

        def idf_of_tid(tid, _pp=pp, _s=searcher, _f=self.field):
            return _s._idf(_f, _pp.terms[tid], 1.0)

        ridx.build_heavy_bank(idf_of_tid)
        ex = RowExecutor(ridx)
        ex.query_cache = getattr(searcher, "enable_query_cache", True)
        ex.idf_of_tid = idf_of_tid
        self.row_executors[si] = ex


class IndexSearcher:
    def __init__(
        self,
        segments: Union[Sequence[Union[SegmentData, DeviceSegment]], "object"],
        device=None,
        hbm_budget_bytes: Optional[int] = None,
        query_cache: bool = True,
    ):
        # LRUQueryCache role (reference: searcher-level query cache, on
        # by default): re-issued identical query batches replay cached
        # per-(batch, segment) phase-1 scoring state. Benches pass False
        # so measured throughput re-scores every iteration.
        self.enable_query_cache = query_cache
        # Accept a DirectoryReader (duck-typed to avoid an import cycle).
        if hasattr(segments, "segments_data"):
            segments = segments.segments_data()
        segments = [
            # ...and reader.leaves() LeafReaderContext entries
            s.reader.data if hasattr(s, "reader") and hasattr(s, "doc_base")
            else s
            for s in segments
        ]
        self._device = device
        self._tier = None
        # caches must exist before tier promotion callbacks can fire
        from collections import OrderedDict

        self.sim = BM25Similarity()
        self._field_ctx: Dict[str, _FieldContext] = {}
        self._phrase_execs: Dict[str, list] = {}
        self._idf_cache: Dict[Tuple[str, str, float], np.float32] = {}
        # LRU: plans hold O(D) host rows for light/range/nested clauses,
        # so an unbounded cache would leak ~4 MB/plan at 1M docs
        self._plan_cache: "OrderedDict[tuple, list]" = OrderedDict()
        self._plan_cache_max = 512
        self._oracle = None  # lazy: compiles nested subtrees to rows
        self._query_cache: Dict[int, tuple] = {}
        self._query_cache_refs: List[Query] = []
        if hbm_budget_bytes is not None:
            # tier-managed residency: segments load to HBM lazily through
            # the TierManager (budget + LRU demotion actually move arrays)
            from diagon_tpu.observability.storage_tiers import (
                StorageTier,
                TierManager,
            )

            self._host_segs: List[SegmentData] = [
                s.source if isinstance(s, DeviceSegment) else s
                for s in segments
            ]
            if any(s is None for s in self._host_segs):
                raise ValueError(
                    "tier-managed searcher needs host segment copies"
                )
            self._seg_index = {
                s.name: i for i, s in enumerate(self._host_segs)
            }
            self.device_segments = [None] * len(self._host_segs)
            self._tier = TierManager(
                hbm_budget_bytes,
                promote=self._tier_promote,
                demote_to_host=self._tier_demote,
            )
            for s in self._host_segs:
                self._tier.register(
                    s.name,
                    StorageTier.HOST,
                    bytes_device=self._estimate_device_bytes(s),
                )
            self._ensure_resident()
        else:
            self.device_segments: List[DeviceSegment] = [
                s if isinstance(s, DeviceSegment) else load_segment(s, device)
                for s in segments
            ]
        self.doc_bases = np.cumsum(
            [0]
            + [
                s.num_docs
                for s in (
                    self._host_segs
                    if self._tier is not None
                    else self.device_segments
                )
            ]
        ).tolist()
        self.max_doc = self.doc_bases[-1]

    # -- storage tiers -------------------------------------------------------
    @staticmethod
    def _estimate_device_bytes(seg: SegmentData) -> int:
        """Rough HBM footprint of a resident segment (packed arrays +
        norms + positions + the idf-scaled heavy bank)."""
        from diagon_tpu.search.row_engine import (
            HEAVY_FRACTION,
            HEAVY_MIN_DF,
        )

        total = 0
        d_pad = max(1024, -(-seg.num_docs // 1024) * 1024)
        for fd in seg.fields.values():
            pp = fd.postings
            total += pp.packed.nbytes + pp.num_blocks * 40
            total += d_pad * 4  # norms widened
            if pp.positions is not None:
                total += pp.positions.nbytes + pp.block_entry_start.nbytes
            threshold = max(HEAVY_MIN_DF, d_pad // HEAVY_FRACTION)
            n_heavy = int((pp.doc_freq >= threshold).sum())
            total += n_heavy * d_pad * 6  # f32 bank + bf16 copy
        return total

    def _tier_promote(self, name: str) -> int:
        si = self._seg_index[name]
        self.device_segments[si] = load_segment(
            self._host_segs[si], self._device
        )
        # rebuild per-field executors for this segment only
        for ctx in self._field_ctx.values():
            ctx.rebuild_segment(self, si)
        self._phrase_execs.clear()
        return self._estimate_device_bytes(self._host_segs[si])

    def _tier_demote(self, name: str) -> None:
        si = self._seg_index[name]
        self.device_segments[si] = None
        for ctx in self._field_ctx.values():
            if si < len(ctx.executors):
                ctx.executors[si] = None
                ctx.row_executors[si] = None
        self._phrase_execs.clear()

    def _ensure_resident(self) -> None:
        """Promote segments to DEVICE (LRU-evicting within the budget)
        before executing a query; segments that cannot fit stay HOST and
        are served by the oracle tier (exact, slower)."""
        if self._tier is None:
            return
        for s in self._host_segs:
            try:
                self._tier.ensure_device(s.name)
            except MemoryError:
                pass

    def _host_segment_topdocs(self, si: int, query: Query, k: int) -> TopDocs:
        """Score one HOST-tier segment with the oracle (exact)."""
        if self._oracle is None:
            from diagon_tpu.search.oracle import OracleSearcher

            self._oracle = OracleSearcher(self._host_segments())
        seg = self._host_segments()[si]
        scores, mask = self._oracle._score_dense(seg, query)
        if seg.live_docs is not None:
            mask = mask & seg.live_docs
        docs = np.nonzero(mask)[0]
        sds = sorted(
            (ScoreDoc(int(d) + self.doc_bases[si], float(scores[d]))
             for d in docs),
            key=lambda sd: (-sd.score, sd.doc),
        )[:k]
        return TopDocs(len(docs), sds)

    def tier_stats(self):
        return self._tier.stats() if self._tier is not None else {}

    # -- stats -------------------------------------------------------------
    def _ctx(self, field: str) -> _FieldContext:
        ctx = self._field_ctx.get(field)
        if ctx is None:
            ctx = _FieldContext(self, field)
            self._field_ctx[field] = ctx
        return ctx

    def term_doc_freq(self, field: str, text: str) -> int:
        df = 0
        for seg in self._host_segments():
            fd = seg.fields.get(field)
            if fd is None:
                continue
            tid = fd.postings.term_id(text)
            if tid >= 0:
                df += int(fd.postings.doc_freq[tid])
        return df

    def _idf(self, field: str, text: str, boost: float) -> np.float32:
        key = (field, text, boost)
        v = self._idf_cache.get(key)
        if v is None:
            df = self.term_doc_freq(field, text)
            if df == 0:
                df = max(1, self.max_doc // 10)  # reference fallback
            v = np.float32(self.sim.idf(df, self.max_doc) * np.float32(boost))
            self._idf_cache[key] = v
        return v

    # -- plan construction ---------------------------------------------------
    @staticmethod
    def _device_rangeable(q: Query) -> bool:
        """Non-term clause types executable as host indicator rows."""
        return isinstance(
            q,
            (NumericRangeQuery, PointRangeQuery, DoubleRangeQuery,
             MatchAllDocsQuery),
        )

    def _any_field(self) -> Optional[str]:
        for seg in self._host_segments():
            for name in seg.fields:
                return name
        return None

    def _term_clauses(
        self, query: Query
    ) -> Optional[Tuple[str, List[Tuple[Query, Occur]], int]]:
        """Flatten into (ctx_field, [(clause, occur)], min_should).

        Every clause type executes on device: same-field terms as bank
        rows; ranges/match-all as host indicator rows; nested boolean
        trees, phrase clauses and foreign-field terms as host-computed
        (score row, match row) pairs (the reference composes nested
        Weights/Scorers, BooleanQuery.cpp:417-481 — here a subtree
        compiles to dense rows the flat kernel consumes). Standalone
        range/match-all queries arrive wrapped as single-SHOULD booleans.
        Returns None only when nothing is indexed or nothing can match
        (pure MUST_NOT)."""
        if isinstance(query, TermQuery):
            return query.term.field, [(query, Occur.SHOULD)], 1
        if isinstance(query, PhraseQuery):
            # single-SHOULD boolean wrapper: batch paths score the phrase
            # via its PhraseExecutor host row (plans_for). Solo search()
            # still prefers the direct _search_phrase candidate kernel.
            return query.field, [(query, Occur.SHOULD)], 1
        if isinstance(
            query,
            (NumericRangeQuery, PointRangeQuery, DoubleRangeQuery,
             MatchAllDocsQuery),
        ):
            field = self._any_field()
            if field is None:
                return None
            return field, [(query, Occur.SHOULD)], 1
        if not isinstance(query, BooleanQuery):
            return None
        clauses: List[Tuple[Query, Occur]] = []
        field = None
        for c in query.clauses:
            q = c.query
            if not isinstance(
                q,
                (
                    TermQuery,
                    BooleanQuery,
                    PhraseQuery,
                    NumericRangeQuery,
                    PointRangeQuery,
                    DoubleRangeQuery,
                    MatchAllDocsQuery,
                ),
            ):
                return None
            if field is None and isinstance(q, TermQuery):
                field = q.term.field
            clauses.append((q, c.occur))
        if field is None:
            field = self._any_field()
        if field is None:
            return None
        min_should = query.minimum_number_should_match
        has_required = any(
            o in (Occur.MUST, Occur.FILTER) for _, o in clauses
        )
        has_should = any(o == Occur.SHOULD for _, o in clauses)
        if has_should and not has_required:
            min_should = max(min_should, 1)
        if not has_should and not has_required:
            return None  # pure MUST_NOT: matches nothing; handled by caller
        return field, clauses, min_should

    @staticmethod
    def _clause_key(q: Query, o: Occur) -> tuple:
        if isinstance(q, TermQuery):
            return (o.value, "T", q.term.field, q.term.text, float(q.boost))
        return (o.value, "Q", repr(q), "", 0.0)

    def _clause_host_row(self, seg, q: Query) -> np.ndarray:
        """Indicator-score row for a range / match-all clause (float32,
        the oracle's exact values: 1.0 at matching docs)."""
        from diagon_tpu.search.oracle import (
            numeric_range_mask,
            point_range_mask,
        )

        if isinstance(q, MatchAllDocsQuery):
            return np.ones(seg.num_docs, dtype=np.float32)
        if isinstance(q, NumericRangeQuery):
            return numeric_range_mask(seg, q.field, q.lower, q.upper).astype(
                np.float32
            )
        if isinstance(q, PointRangeQuery):
            return point_range_mask(seg, q.field, q.lower, q.upper).astype(
                np.float32
            )
        if isinstance(q, DoubleRangeQuery):
            from diagon_tpu.search.oracle import double_range_mask

            return double_range_mask(
                seg, q.field, q.lower, q.upper,
                q.include_lower, q.include_upper,
            ).astype(np.float32)
        raise TypeError(f"no host row for {q!r}")

    def _oracle_rows(self, si: int, q: Query):
        """(masked score row f32, match row f32) for one clause of one
        segment, with the oracle's exact global-stats arithmetic — the
        compile target for nested boolean trees, phrase clauses and
        foreign-field terms inside a device boolean plan."""
        if self._oracle is None:
            from diagon_tpu.search.oracle import OracleSearcher

            self._oracle = OracleSearcher(self._host_segments())
        scores, mask = self._oracle._score_dense(
            self._oracle.segments[si], q
        )
        return scores, mask.astype(np.float32)

    def _clause_term_plans(
        self, field: str, clauses: List[Tuple[Query, Occur]]
    ) -> List[List[TermPlan]]:
        """Per-segment TermPlan lists in oracle accumulation order
        (MUST sorted, FILTER sorted, SHOULD sorted, MUST_NOT sorted; the
        sort key matches OracleSearcher._score_boolean: non-term clauses
        sort first, stably)."""

        def _key(item):
            q = item[0]
            return (
                (q.term.field, q.term.text)
                if isinstance(q, TermQuery)
                else ("", "")
            )

        must = sorted([c for c in clauses if c[1] == Occur.MUST], key=_key)
        should = sorted([c for c in clauses if c[1] == Occur.SHOULD], key=_key)
        filt = sorted([c for c in clauses if c[1] == Occur.FILTER], key=_key)
        must_not = sorted(
            [c for c in clauses if c[1] == Occur.MUST_NOT], key=_key
        )
        weights = {
            id(q): (
                float(self._idf(field, q.term.text, q.boost))
                if isinstance(q, TermQuery) and q.term.field == field
                else 1.0
            )
            for q, _ in must + should
        }
        out = []
        for si, ds in enumerate(self.device_segments):
            f = ds.fields.get(field) if ds is not None else None
            if f is None:
                out.append(None)
                continue

            def plans_for(q, weight, scoring: bool, **flags):
                """1-2 TermPlans for one clause (A/B split when the match
                set can include zero-score docs, i.e. nested booleans)."""
                if isinstance(q, TermQuery) and q.term.field == field:
                    return [TermPlan(f.term_id(q.term.text), weight, **flags)]
                if self._device_rangeable(q):
                    return [
                        TermPlan(
                            -1,
                            weight,
                            host_row=self._clause_host_row(ds.source, q),
                            **flags,
                        )
                    ]
                if isinstance(q, PhraseQuery) and q.field == field:
                    # device position-intersection kernel builds the
                    # clause rows (the numpy oracle costs ~9-51 s per
                    # phrase clause at 1M docs; see PhraseExecutor
                    # .score_row) — bit-identical scores
                    ex = self._phrase_executors(field)[si]
                    if ex is not None:
                        scores, match = ex.score_row(
                            q.terms,
                            self._phrase_idf(q),
                            self.device_segments[si].num_docs,
                        )
                        row = scores if scoring else match
                        return [TermPlan(-1, 1.0 if scoring else 0.0,
                                         host_row=row, **flags)]
                scores, match = self._oracle_rows(si, q)
                if isinstance(q, BooleanQuery):
                    # A: score contribution at this clause's position;
                    # B: presence (a nested match may carry score 0).
                    plans = []
                    if scoring:
                        plans.append(TermPlan(-1, 1.0, host_row=scores))
                    plans.append(TermPlan(-1, 0.0, host_row=match, **flags))
                    return plans
                # phrase / foreign-field term: score > 0 iff matched, so
                # one row serves both roles
                row = scores if scoring else match
                return [TermPlan(-1, 1.0 if scoring else 0.0,
                                 host_row=row, **flags)]

            tps: List[TermPlan] = []
            for q, _ in must:
                tps.extend(
                    plans_for(q, weights[id(q)], True, required=True)
                )
            for q, _ in filt:
                tps.extend(plans_for(q, 0.0, False, required=True))
            for q, _ in should:
                tps.extend(plans_for(q, weights[id(q)], True, should=True))
            for q, _ in must_not:
                tps.extend(plans_for(q, 0.0, False, negated=True))
            out.append(tps)
        return out

    def _cached_query_plans(self, query: Query):
        """(field, row plans) for a query, cached by object identity."""
        hit = self._query_cache.get(id(query))
        if hit is not None:
            return hit
        tc = self._term_clauses(query)
        if tc is None:
            out = None
        else:
            field, clauses, min_should = tc
            out = (field, self._row_plans(field, clauses, min_should))
        if len(self._query_cache) < 4096:
            self._query_cache[id(query)] = out
            self._query_cache_refs.append(query)  # keep ids stable
        return out

    def _row_plans(
        self,
        field: str,
        clauses: List[Tuple[TermQuery, Occur]],
        min_should: int,
    ):
        cache_key = (
            "row",
            field,
            tuple(sorted(self._clause_key(q, o) for q, o in clauses)),
            min_should,
        )
        cached = self._plan_cache.get(cache_key)
        if cached is not None:
            self._plan_cache.move_to_end(cache_key)
            return cached
        ctx = self._ctx(field)
        plans = []
        for si, tps in enumerate(self._clause_term_plans(field, clauses)):
            ex = ctx.row_executors[si]
            if tps is None or ex is None:
                plans.append(None)
                continue
            plans.append(ex.build_plan(tps, min_should, ex.idf_of_tid))
        self._plan_cache[cache_key] = plans
        while len(self._plan_cache) > self._plan_cache_max:
            self._plan_cache.popitem(last=False)
        return plans

    def _segment_plans(
        self,
        field: str,
        clauses: List[Tuple[TermQuery, Occur]],
        min_should: int,
    ) -> List[Optional[SegmentPlan]]:
        cache_key = (
            field,
            tuple(sorted(self._clause_key(q, o) for q, o in clauses)),
            min_should,
        )
        cached = self._plan_cache.get(cache_key)
        if cached is not None:
            self._plan_cache.move_to_end(cache_key)
            return cached
        ctx = self._ctx(field)
        # Deterministic accumulation order: sort scoring clauses by term text
        # (matches the oracle's per-group sorted order).
        def _key(item):
            return item[0].term.text

        must = sorted([c for c in clauses if c[1] == Occur.MUST], key=_key)
        should = sorted([c for c in clauses if c[1] == Occur.SHOULD], key=_key)
        filt = sorted([c for c in clauses if c[1] == Occur.FILTER], key=_key)
        must_not = sorted(
            [c for c in clauses if c[1] == Occur.MUST_NOT], key=_key
        )

        weights = {
            id(q): float(self._idf(field, q.term.text, q.boost))
            for q, _ in must + should
        }

        plans: List[Optional[SegmentPlan]] = []
        for ds in self.device_segments:
            f = ds.fields.get(field)
            if f is None:
                plans.append(None)
                continue
            tps: List[TermPlan] = []
            for q, _ in must:
                tps.append(
                    TermPlan(
                        f.term_id(q.term.text),
                        weights[id(q)],
                        required=True,
                    )
                )
            for q, _ in filt:
                tps.append(TermPlan(f.term_id(q.term.text), 0.0, required=True))
            for q, _ in should:
                tps.append(
                    TermPlan(f.term_id(q.term.text), weights[id(q)], should=True)
                )
            for q, _ in must_not:
                tps.append(TermPlan(f.term_id(q.term.text), 0.0, negated=True))
            plans.append(
                build_segment_plan(
                    f, tps, min_should, float(1.0 / ctx.avgdl)
                )
            )
        self._plan_cache[cache_key] = plans
        while len(self._plan_cache) > self._plan_cache_max:
            self._plan_cache.popitem(last=False)
        return plans

    # -- public API ----------------------------------------------------------
    def search(self, query: Query, k: int = 10) -> TopDocs:
        from diagon_tpu.observability.profiler import ProfileScope

        self._ensure_resident()
        if isinstance(query, PhraseQuery):
            # direct candidate-set kernel beats the dense-row batch path
            # for a SOLO phrase (no batch to amortize the row build)
            with ProfileScope("phrase"):
                return self._search_phrase(query, k)
        tc = self._term_clauses(query)
        if tc is not None:
            field, clauses, min_should = tc
            ctx = self._ctx(field)
            use_row = all(
                te is not None or ctx.executors[si] is None
                for si, te in enumerate(ctx.row_executors)
            )
            if not use_row and any(
                not isinstance(q, TermQuery) for q, _ in clauses
            ):
                return self._fallback_search(query, k)
            with ProfileScope("plan"):
                if use_row:
                    plans = self._row_plans(field, clauses, min_should)
                else:
                    plans = self._segment_plans(field, clauses, min_should)
            parts: List[TopDocs] = []
            with ProfileScope("execute"):
                for si, plan in enumerate(plans):
                    if plan is None:
                        # tier-demoted segment: serve from the HOST tier
                        if (
                            self._tier is not None
                            and self.device_segments[si] is None
                        ):
                            parts.append(
                                self._host_segment_topdocs(si, query, k)
                            )
                        continue
                    ex = (
                        ctx.row_executors[si] if use_row else ctx.executors[si]
                    )
                    kk = min(k, self.device_segments[si].num_docs_pad)
                    scores, docs, hits = ex.top_k(plan, kk)
                    parts.append(
                        self._to_topdocs(si, scores, docs, hits)
                    )
            with ProfileScope("merge"):
                return merge_top_docs(parts, k)

        return self._fallback_search(query, k)

    def search_batch(self, queries: Sequence[Query], k: int = 10) -> List[TopDocs]:
        """Execute a batch of term/boolean queries in one device program per
        segment. Results are identical to per-query ``search``; throughput is
        the point (the reference has no equivalent — it is single-query
        doc-at-a-time)."""
        self._ensure_resident()
        if self._tier is not None and any(
            ds is None for ds in self.device_segments
        ):
            # working set exceeds the HBM budget: per-query path handles
            # the HOST-tier segments
            return [self.search(q, k) for q in queries]
        flat: List[Tuple[str, List[Tuple[TermQuery, Occur]], int]] = []
        for q in queries:
            tc = self._term_clauses(q)
            if tc is None:
                raise ValueError(
                    f"search_batch supports term/boolean-of-term queries; got {q!r}"
                )
            flat.append(tc)
        fields = {f for f, _, _ in flat}
        if len(fields) != 1:
            raise ValueError("search_batch requires a single field per batch")
        field = fields.pop()
        ctx = self._ctx(field)
        use_row = all(
            te is not None or ctx.executors[si] is None
            for si, te in enumerate(ctx.row_executors)
        )
        if not use_row and any(
            not isinstance(q, TermQuery)
            for _, cl, _ms in flat
            for q, _o in cl
        ):
            return [self.search(q, k) for q in queries]

        per_seg_plans = []
        for f, clauses, min_should in flat:
            if use_row:
                per_seg_plans.append(self._row_plans(field, clauses, min_should))
            else:
                per_seg_plans.append(
                    self._segment_plans(field, clauses, min_should)
                )

        results: List[List[TopDocs]] = [[] for _ in queries]
        for si, ds in enumerate(self.device_segments):
            if field not in ds.fields:
                continue
            plans = [pp[si] for pp in per_seg_plans]
            if any(p is None for p in plans):
                continue
            ex = ctx.row_executors[si] if use_row else ctx.executors[si]
            kk = min(k, ds.num_docs_pad)
            scores, docs, hits = ex.top_k_batch(plans, kk)
            scores = np.asarray(scores)
            docs = np.asarray(docs)
            hits = np.asarray(hits)
            for qi in range(len(queries)):
                results[qi].append(
                    self._to_topdocs(si, scores[qi], docs[qi], hits[qi])
                )
        return [merge_top_docs(parts, k) for parts in results]

    def dispatch_batch(self, queries: Sequence[Query], k: int = 10):
        """Async variant of search_batch: returns an opaque handle without
        waiting for results. Use with ``collect_batch`` to pipeline many
        batches through the device (the serving pattern: readback latency
        amortizes across in-flight batches)."""
        self._ensure_resident()
        if self._tier is not None and any(
            ds is None for ds in self.device_segments
        ):
            raise MemoryError(
                "dispatch_batch requires the full working set resident; "
                "the HBM budget is too small for these segments"
            )
        flat = []
        for q in queries:
            qp = self._cached_query_plans(q)
            if qp is None:
                raise ValueError(f"dispatch_batch: unsupported query {q!r}")
            flat.append(qp)
        field = flat[0][0]
        ctx = self._ctx(field)
        handles = []
        for si, ds in enumerate(self.device_segments):
            ex = ctx.row_executors[si]
            if ex is None:
                continue
            plans = [seg_plans[si] for _, seg_plans in flat]
            kk = min(k, ds.num_docs_pad)
            fused = ex.dispatch(plans, kk)
            handles.append((si, kk, fused, ex, plans))
        return (len(queries), k, handles)

    def collect_many(self, handles) -> List[List[TopDocs]]:
        """Resolve many dispatch_batch handles with ONE device->host
        transfer (each fetch has a fixed latency): stacks every handle's fused outputs on device, reads
        once, then decodes."""
        import jax.numpy as jnp

        # group fused arrays by (segment, k) shape
        all_fused = [f for _, _, parts in handles for _, _, f, _, _ in parts]
        if not all_fused:
            return [self.collect_batch(h) for h in handles]
        stacked = np.asarray(jnp.concatenate([f.reshape(-1) for f in all_fused]))
        out: List[List[TopDocs]] = []
        pos = 0
        for nq, k, parts in handles:
            results: List[List[TopDocs]] = [[] for _ in range(nq)]
            for si, kk, f, ex, plans in parts:
                n = int(np.prod(f.shape))
                flat = stacked[pos : pos + n].reshape(f.shape)
                pos += n
                scores, docs, hits = ex.finalize(plans, flat, kk)
                for qi in range(nq):
                    results[qi].append(
                        self._to_topdocs(si, scores[qi], docs[qi], hits[qi])
                    )
            out.append([merge_top_docs(parts_q, k) for parts_q in results])
        return out

    def collect_batch(self, handle) -> List[TopDocs]:
        """Resolve a dispatch_batch handle into per-query TopDocs."""
        nq, k, parts_h = handle
        results: List[List[TopDocs]] = [[] for _ in range(nq)]
        for si, kk, fused, ex, plans in parts_h:
            scores, docs, hits = ex.finalize(plans, fused, kk)
            for qi in range(nq):
                results[qi].append(
                    self._to_topdocs(si, scores[qi], docs[qi], hits[qi])
                )
        return [merge_top_docs(parts, k) for parts in results]

    def count(self, query: Query) -> int:
        self._ensure_resident()
        # O(1) fast paths (reference Weight::count, IndexSearcher.cpp:128):
        # with no deletes, a term's count is its docFreq and match-all is
        # maxDoc — no device round trip.
        if all(
            s.live_docs is None for s in self._host_segments()
        ):
            if isinstance(query, TermQuery):
                return self.term_doc_freq(query.term.field, query.term.text)
            if isinstance(query, MatchAllDocsQuery):
                return self.max_doc
        tc = self._term_clauses(query)
        if tc is not None:
            field, clauses, min_should = tc
            ctx = self._ctx(field)
            use_row = all(
                te is not None or ctx.executors[si] is None
                for si, te in enumerate(ctx.row_executors)
            )
            if not use_row and any(
                not isinstance(q, TermQuery) for q, _ in clauses
            ):
                return self._fallback_count(query)
            if use_row:
                plans = self._row_plans(field, clauses, min_should)
            else:
                plans = self._segment_plans(field, clauses, min_should)
            total = 0
            for si, plan in enumerate(plans):
                if plan is None:
                    if (
                        self._tier is not None
                        and self.device_segments[si] is None
                    ):
                        total += self._host_segment_topdocs(
                            si, query, 1
                        ).total_hits
                    continue
                ex = ctx.row_executors[si] if use_row else ctx.executors[si]
                total += ex.count(plan)
            return total
        return self._fallback_count(query)

    # -- phrase --------------------------------------------------------------
    def _phrase_executors(self, field: str):
        from diagon_tpu.search.phrase import PhraseExecutor

        ctx = self._ctx(field)
        execs = self._phrase_execs.get(field)
        if execs is None:
            execs = []
            for ds in self.device_segments:
                ex = None
                if ds is not None and field in ds.fields:
                    try:
                        ex = PhraseExecutor(ds, field, ctx.tf_lut)
                    except ValueError:  # no positions / no host source
                        ex = None
                execs.append(ex)
            self._phrase_execs[field] = execs
        return execs

    def _phrase_idf(self, query: PhraseQuery) -> float:
        # idf from the rarest term (PhraseQuery.cpp:304-338)
        min_df = self.max_doc
        for t in query.terms:
            df = self.term_doc_freq(query.field, t)
            if df > 0:
                min_df = min(min_df, df)
        if min_df <= 0:
            min_df = 1
        return float(
            self.sim.idf(min_df, self.max_doc) * np.float32(query.boost)
        )

    def _search_phrase(self, query: PhraseQuery, k: int) -> TopDocs:
        self._ensure_resident()
        execs = self._phrase_executors(query.field)
        idf = self._phrase_idf(query)

        parts: List[TopDocs] = []
        for si, ex in enumerate(execs):
            if ex is None:
                if (
                    self._tier is not None
                    and self.device_segments[si] is None
                    and query.field in self._host_segments()[si].fields
                ):
                    parts.append(self._host_segment_topdocs(si, query, k))
                continue
            res = ex.top_k(query.terms, idf, k)
            if res is None:
                continue
            scores, docs, hits = res
            parts.append(self._to_topdocs(si, scores, docs, hits))
        return merge_top_docs(parts, k)

    # -- fallback (host scalar) ----------------------------------------------
    def _host_segments(self) -> List[SegmentData]:
        if self._tier is not None:
            return self._host_segs
        segs = []
        for ds in self.device_segments:
            if ds.source is None:
                raise RuntimeError(
                    "host fallback requires segments loaded with keep_source=True"
                )
            segs.append(ds.source)
        return segs

    def _fallback_search(self, query: Query, k: int) -> TopDocs:
        from diagon_tpu.search.oracle import OracleSearcher

        return OracleSearcher(self._host_segments()).search(query, k)

    def _fallback_count(self, query: Query) -> int:
        from diagon_tpu.search.oracle import OracleSearcher

        return OracleSearcher(self._host_segments()).count(query)

    # -- helpers ---------------------------------------------------------------
    def _to_topdocs(self, si: int, scores, docs, hits) -> TopDocs:
        scores = np.asarray(scores)
        docs = np.asarray(docs)
        hits = int(hits)
        base = self.doc_bases[si]
        sds = [
            ScoreDoc(int(d) + base, float(s))
            for s, d in zip(scores, docs)
            if s >= 0.0
        ][:hits]
        return TopDocs(hits, sds)
