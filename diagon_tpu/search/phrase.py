"""Device phrase query execution (slop = 0).

Replaces the reference's doc-at-a-time PhraseScorer
(``search/PhraseQuery.cpp:27-202``: conjunction advance + sequential
position-list walk) with a host/device split that plays to each side's
strength:

- **Host (exact, cached)**: the conjunction. Per-term docid lists decode
  once from the packed blocks (numpy, cached per term) and intersect with
  ``np.intersect1d`` — the candidate set and each candidate's per-term
  posting-entry index are exact, so the device kernel needs no scatter, no
  candidate top_k, and no overflow escalation.
- **Device (vectorized)**: position intersection + scoring. Gather each
  candidate's per-term position windows (contiguous slices of the flat
  positions array) and count lead positions ``p`` with term ``i`` at
  ``p + i`` via a branch-free [C, P, P] broadcast compare — pure elementwise work.

Scoring: BM25 with phraseFreq as tf and the rarest member term's docFreq
for IDF (PhraseQuery.cpp:304-338), via the same host-exact tf lookup table.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from diagon_tpu.search.device_index import DeviceSegment

_POS_SENTINEL = np.int32(2**30)


@partial(jax.jit, static_argnames=("pos_caps", "lead", "k"))
def phrase_positions_topk(
    pos_start,  # int32 [NE+1]
    positions,  # int32 [NP]
    norms,  # int32 [num_docs_pad]
    tf_lut,  # f32 [128*F]
    cand,  # int32 [C] candidate docids (-1 pad)
    ent,  # int32 [n_terms, C] posting-entry ids per candidate
    idf,  # f32 []
    *,
    pos_caps: tuple,  # per-term position-window widths (static)
    lead: int,  # anchor slot = rarest term (its tf bounds phraseFreq)
    k: int,
):
    num_docs_pad = norms.shape[0]
    cand_ok = cand >= 0
    n_terms = len(pos_caps)
    C = ent.shape[1]

    def window(i):
        """[C, 2*P_i] positions of term i per candidate (sentinel-padded).

        ALIGNED row gather: the flat positions array is viewed as rows of
        P_i; an entry of <= P_i positions spans at most two such rows, so
        two row gathers + a validity mask (global index in [p_lo, p_hi))
        fetch it with contiguous DMAs. Shifting the window to the entry
        start (take_along_axis / dynamic_slice) lowers to per-element
        loads and dominated phrase latency; masking instead of shifting
        keeps everything row-shaped."""
        p_lo = pos_start[jnp.maximum(ent[i], 0)]  # [C]
        p_hi = pos_start[jnp.maximum(ent[i], 0) + 1]
        P = pos_caps[i]
        pad = (-positions.shape[0]) % P + P  # tail + one slack row
        resh = jnp.concatenate(
            [positions, jnp.full((pad,), _POS_SENTINEL, jnp.int32)]
        ).reshape(-1, P)
        n_rows = resh.shape[0]
        row = jnp.clip(p_lo // P, 0, n_rows - 1)
        a = resh[row]  # [C, P]
        b = resh[jnp.minimum(row + 1, n_rows - 1)]
        vals = jnp.concatenate([a, b], axis=1)  # [C, 2P]
        gidx = row[:, None] * P + jnp.arange(2 * P, dtype=jnp.int32)[None, :]
        ok = (gidx >= p_lo[:, None]) & (gidx < p_hi[:, None])
        return jnp.where(ok, vals, _POS_SENTINEL), ok

    # Anchor on the rarest term (smallest tf window): for each of its
    # positions p, term i must appear at p + (i - lead). Membership is a
    # branch-free [C, P_lead, P_i] broadcast compare + any-reduce — pure
    # elementwise work (a vmapped searchsorted lowers to a sequential gather
    # loop: "stock market" cost 216 ms in that form).
    lead_w, lead_ok = window(lead)
    found = lead_ok
    for i in range(n_terms):
        if i == lead:
            continue
        target = lead_w + jnp.int32(i - lead)
        arr, _ = window(i)
        hit = jnp.any(arr[:, None, :] == target[:, :, None], axis=2)
        found = found & hit
    pfreq = jnp.sum(found.astype(jnp.int32), axis=1)  # [C]

    matched = cand_ok & (pfreq > 0)
    hits = jnp.sum(matched.astype(jnp.int32))

    F = tf_lut.shape[0] // 128
    norm_c = norms[jnp.clip(cand, 0, num_docs_pad - 1)]
    tf_factor = tf_lut[norm_c * F + jnp.clip(pfreq, 0, F - 1)]
    scores = jnp.where(matched, idf * tf_factor, jnp.float32(-1.0))

    top_scores, top_i = jax.lax.top_k(scores, k)
    top_docs = cand[top_i]
    # Single fused output -> one host readback. Ints travel as exact f32
    # values (not bitcasts — flush-to-zero would zero denormal patterns).
    return jnp.concatenate(
        [
            top_scores,
            top_docs.astype(jnp.float32),
            hits[None].astype(jnp.float32),
        ]
    )


class PhraseExecutor:
    """Per-(segment, field) phrase runner: host conjunction + device
    position intersection."""

    def __init__(self, segment: DeviceSegment, field_name: str, tf_lut):
        self.segment = segment
        self.field = segment.field(field_name)
        if not self.field.with_positions:
            raise ValueError(
                f"field {field_name!r} was indexed without positions"
            )
        if segment.source is None:
            raise ValueError("phrase execution requires the host segment")
        self._host_pp = segment.source.fields[field_name].postings
        self._live_host = segment.source.live_docs
        self.tf_lut = tf_lut
        self._term_docs: Dict[int, np.ndarray] = {}
        self._plan_cache: Dict[tuple, tuple] = {}
        self._row_cache: Dict[tuple, tuple] = {}

    def _docs_of(self, tid: int) -> np.ndarray:
        """Decoded ascending docids of one term (cached)."""
        got = self._term_docs.get(tid)
        if got is None:
            from diagon_tpu.codecs.postings import decode_block_numpy

            pp = self._host_pp
            parts = [
                decode_block_numpy(pp, b)[0]
                for b in range(
                    int(pp.block_start[tid]), int(pp.block_start[tid + 1])
                )
            ]
            got = (
                np.concatenate(parts)
                if parts
                else np.zeros(0, dtype=np.int32)
            )
            if len(self._term_docs) < 4096:
                self._term_docs[tid] = got
        return got

    def _plan(self, terms: List[str]):
        """(cand_pad, ent_pad, pos_cap) host conjunction plan, cached."""
        key = tuple(terms)
        got = self._plan_cache.get(key)
        if got is not None:
            return got
        f = self.field
        pp = self._host_pp
        tids = [f.term_id(t) for t in terms]
        if any(t < 0 for t in tids):
            plan = None
        else:
            conj = self._docs_of(tids[0])
            for tid in tids[1:]:
                conj = np.intersect1d(
                    conj, self._docs_of(tid), assume_unique=True
                )
            if self._live_host is not None and len(conj):
                conj = conj[self._live_host[conj]]
            if len(conj) == 0:
                plan = ([], None, None, tids)
            else:
                C = max(8, 1 << int(np.ceil(np.log2(len(conj)))))
                cand = np.full(C, -1, dtype=np.int32)
                cand[: len(conj)] = conj
                ent = np.zeros((len(tids), C), dtype=np.int32)
                pos_caps = []
                for i, tid in enumerate(tids):
                    docs_t = self._docs_of(tid)
                    base = int(
                        pp.block_entry_start[int(pp.block_start[tid])]
                    )
                    ent[i, : len(conj)] = base + np.searchsorted(
                        docs_t, conj
                    )
                    bs, be = int(pp.block_start[tid]), int(
                        pp.block_start[tid + 1]
                    )
                    max_tf = (
                        int(pp.block_max_freq[bs:be].max()) if be > bs else 1
                    )
                    pos_caps.append(
                        max(4, 1 << int(np.ceil(np.log2(max_tf))))
                    )
                lead = int(np.argmin([len(self._docs_of(t)) for t in tids]))
                plan = (
                    jnp.asarray(cand),
                    jnp.asarray(ent),
                    (tuple(pos_caps), lead),
                    tids,
                )
        if len(self._plan_cache) < 1024:
            self._plan_cache[key] = plan
        return plan

    def top_k(
        self, terms: List[str], idf: float, k: int
    ) -> Optional[Tuple[np.ndarray, np.ndarray, int]]:
        plan = self._plan(terms)
        if plan is None:
            return None  # a term is missing: no phrase matches here
        cand, ent, caps_lead, _tids = plan
        if isinstance(cand, list):  # empty conjunction
            return (
                np.full(k, -1.0, dtype=np.float32),
                np.zeros(k, dtype=np.int32),
                0,
            )
        pos_caps, lead = caps_lead
        f = self.field
        f.ensure_positions()  # lazy HBM upload (phrase-only data)
        kk = min(k, cand.shape[0])
        fused = np.asarray(
            phrase_positions_topk(
                f.pos_start,
                f.positions,
                f.norms,
                self.tf_lut,
                cand,
                ent,
                jnp.float32(idf),
                pos_caps=pos_caps,
                lead=lead,
                k=kk,
            )
        )
        scores = fused[:kk]
        docs = fused[kk : 2 * kk].astype(np.int32)
        hits = int(fused[2 * kk])
        if kk < k:
            scores = np.concatenate(
                [scores, np.full(k - kk, -1.0, np.float32)]
            )
            docs = np.concatenate([docs, np.zeros(k - kk, np.int32)])
        return scores, docs, hits

    def score_row(self, terms: List[str], idf: float, num_docs: int):
        """Exact phrase clause rows: (scores f32 [num_docs], match f32
        [num_docs]) — the compile target for phrase clauses inside
        boolean device plans. Same device position-intersection kernel
        as top_k, run over the FULL candidate conjunction (k = C), so
        one kernel + one readback replaces the numpy oracle's
        per-candidate intersection (measured ~9-51 s per clause at 1M
        docs vs ~50 ms here). Scores are bit-identical to the oracle's
        (idf * tf_lut lookup, single f32 multiply — no FMA exposure).

        Memoized by (terms, idf): a serving batch of phrase QUERY
        objects repeating the same phrase text would otherwise pay one
        device kernel + one readback PER OBJECT (the searcher's plan
        cache is per query object, not per text)."""
        ck = (tuple(terms), float(idf))
        got = self._row_cache.get(ck)
        if got is not None:
            return got
        row = np.zeros(num_docs, np.float32)
        plan = self._plan(terms)
        if plan is None or isinstance(plan[0], list):
            out = (row, np.zeros(num_docs, np.float32))
        else:
            C = int(plan[0].shape[0])
            scores, docs, _hits = self.top_k(terms, idf, C)
            ok = scores > 0
            row[docs[ok]] = scores[ok]
            out = (row, (row > 0).astype(np.float32))
        if len(self._row_cache) < 64:
            self._row_cache[ck] = out
        return out
