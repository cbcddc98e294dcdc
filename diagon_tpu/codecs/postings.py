"""Packed posting-block format — the heart of the index.

Accelerator-native replacement for the reference's Lucene104 postings
(``codecs/lucene104/Lucene104PostingsWriter.h:23-90``: 128-doc PFOR blocks in
a ``.doc`` byte stream plus ``.skp`` skip entries). Here a segment's postings
for one field are a **struct-of-arrays**: every posting block is described by
one row of dense per-block metadata plus a slice of a single shared uint32
word stream. This makes the block table itself the skip list: block-max
pruning is a vectorized comparison over the ``[n_blocks]`` metadata arrays,
and decoding a block is two gathers + shifts.

Block layout (block = up to 128 postings of ONE term, docids ascending):

- doc-id deltas ``d[0]=0, d[i]=doc[i]-doc[i-1]`` packed at ``doc_bits``
  (per-block width), starting at word ``word_off``, word-aligned;
- freqs packed at ``freq_bits``, starting at word
  ``word_off + ceil(count*doc_bits/32)`` (word-aligned).

Per-block metadata (the ``.skp`` equivalent, kept as columns so pruning and
decode address it with vector loads):

- ``term``      int32  owner term id
- ``base``      int32  docid of first posting in the block
- ``count``     int32  number of valid postings (<= 128)
- ``doc_bits``  int32  bit width of the delta section
- ``freq_bits`` int32  bit width of the freq section
- ``word_off``  int32  offset of the block in the shared word stream
- ``max_freq``  int32  max freq in the block      (WAND upper bound input)
- ``max_norm``  int32  max norm byte in the block (shortest doc => max score)

Per-term columns: ``block_start`` (CSR offsets into the block table),
``doc_freq``, ``total_tf``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from diagon_tpu.codecs.bitpack import bits_needed, pack_u32, words_for

BLOCK_SIZE = 128


@dataclass
class PackedPostings:
    """One field's postings for one segment, as dense numpy arrays."""

    # per-term (T terms), term strings sorted ascending; tid = rank
    terms: List[str]
    block_start: np.ndarray  # int32 [T+1]
    doc_freq: np.ndarray  # int32 [T]
    total_tf: np.ndarray  # int64 [T]

    # per-block (NB blocks)
    block_term: np.ndarray  # int32 [NB]
    block_base: np.ndarray  # int32 [NB]
    block_count: np.ndarray  # int32 [NB]
    block_doc_bits: np.ndarray  # int32 [NB]
    block_freq_bits: np.ndarray  # int32 [NB]
    block_word_off: np.ndarray  # int32 [NB]
    block_max_freq: np.ndarray  # int32 [NB]
    block_max_norm: np.ndarray  # int32 [NB]
    # CSR offset of each block's first posting in segment posting order —
    # needed to address the positions arrays (entry_start[NB+1]).
    block_entry_start: np.ndarray  # int64 [NB+1]

    packed: np.ndarray  # uint32 [W] shared word stream (padded with slack)

    # positions (present iff the field was indexed with positions):
    # per posting-entry CSR offsets into the flat positions array.
    pos_start: Optional[np.ndarray] = None  # int64 [NE+1]
    positions: Optional[np.ndarray] = None  # int32 [NP] absolute, ascending
    # lazy position decode: read_segment defers the delta-decode +
    # prefix-sum reconstruction (minutes of one-core CPU at 10M docs)
    # behind this thunk; only phrase execution forces it
    pos_loader: Optional[object] = None  # () -> (pos_start, positions)

    # collection stats for the field
    sum_total_tf: int = 0
    sum_doc_freq: int = 0
    doc_count_with_field: int = 0

    # static decode-window size (words) covering any block's both sections
    max_window_words: int = 1

    @property
    def has_positions(self) -> bool:
        return self.pos_start is not None or self.pos_loader is not None

    def ensure_positions(self) -> None:
        """Materialize pos_start/positions from the lazy loader."""
        if self.pos_start is None and self.pos_loader is not None:
            self.pos_start, self.positions = self.pos_loader()
            self.pos_loader = None

    @property
    def num_terms(self) -> int:
        return len(self.terms)

    @property
    def num_blocks(self) -> int:
        return len(self.block_term)

    def term_id(self, term: str) -> int:
        """Hashed/sorted term lookup; -1 if absent (reference: FST seekExact)."""
        lo, hi = 0, len(self.terms)
        while lo < hi:
            mid = (lo + hi) // 2
            if self.terms[mid] < term:
                lo = mid + 1
            else:
                hi = mid
        if lo < len(self.terms) and self.terms[lo] == term:
            return lo
        return -1


def build_packed_postings(
    term_postings: Dict[str, Tuple[np.ndarray, np.ndarray]],
    term_positions: Optional[Dict[str, List[np.ndarray]]] = None,
    norms: Optional[np.ndarray] = None,
) -> PackedPostings:
    """Pack per-term (docids, freqs) arrays into the block format.

    ``term_postings``: term -> (docids int array ascending, freqs int array).
    ``term_positions``: term -> list of per-doc position arrays (parallel to
    docids), or None for fields without positions.
    ``norms``: uint8 per-doc norm array used to compute block max-norm
    (may be None — max_norm falls back to 127).
    """
    terms = sorted(term_postings.keys())
    T = len(terms)

    block_start = np.zeros(T + 1, dtype=np.int32)
    doc_freq = np.zeros(T, dtype=np.int32)
    total_tf = np.zeros(T, dtype=np.int64)

    b_term: List[int] = []
    b_base: List[int] = []
    b_count: List[int] = []
    b_dbits: List[int] = []
    b_fbits: List[int] = []
    b_woff: List[int] = []
    b_maxf: List[int] = []
    b_maxn: List[int] = []
    b_estart: List[int] = [0]

    word_chunks: List[np.ndarray] = []
    word_off = 0

    pos_lists: List[np.ndarray] = []
    pos_counts: List[int] = []
    with_positions = term_positions is not None

    for tid, term in enumerate(terms):
        docs, freqs = term_postings[term]
        docs = np.asarray(docs, dtype=np.int64)
        freqs = np.asarray(freqs, dtype=np.int64)
        df = len(docs)
        doc_freq[tid] = df
        total_tf[tid] = int(freqs.sum())
        block_start[tid] = len(b_term)

        plist = term_positions[term] if with_positions else None

        for s in range(0, df, BLOCK_SIZE):
            e = min(s + BLOCK_SIZE, df)
            bdocs = docs[s:e]
            bfreqs = freqs[s:e]
            count = e - s
            deltas = np.diff(bdocs, prepend=bdocs[0])
            dbits = bits_needed(int(deltas.max()) if count > 1 else 0)
            maxf = int(bfreqs.max())
            if maxf == 1:
                # all-freq-1 block: freq section omitted (fbits == 0)
                fbits = 0
                fwords = np.zeros(0, dtype=np.uint32)
            else:
                fbits = bits_needed(maxf)
                fwords = pack_u32(bfreqs, fbits)
            dwords = pack_u32(deltas, dbits)

            b_term.append(tid)
            b_base.append(int(bdocs[0]))
            b_count.append(count)
            b_dbits.append(dbits)
            b_fbits.append(fbits)
            b_woff.append(word_off)
            b_maxf.append(int(bfreqs.max()))
            if norms is not None:
                b_maxn.append(int(norms[bdocs].max()))
            else:
                b_maxn.append(127)
            b_estart.append(b_estart[-1] + count)

            word_chunks.append(dwords)
            word_chunks.append(fwords)
            word_off += len(dwords) + len(fwords)

            if with_positions:
                for j in range(s, e):
                    p = np.asarray(plist[j], dtype=np.int32)
                    pos_lists.append(p)
                    pos_counts.append(len(p))

    block_start[T] = len(b_term)

    max_window = 1
    for db, fb in zip(b_dbits, b_fbits):
        w = words_for(BLOCK_SIZE, db) + words_for(BLOCK_SIZE, fb)
        max_window = max(max_window, w)

    # Slack so a full max_window gather at the last block stays in bounds.
    packed = (
        np.concatenate(word_chunks + [np.zeros(max_window + 1, dtype=np.uint32)])
        if word_chunks
        else np.zeros(max_window + 1, dtype=np.uint32)
    )

    pp = PackedPostings(
        terms=terms,
        block_start=block_start,
        doc_freq=doc_freq,
        total_tf=total_tf,
        block_term=np.asarray(b_term, dtype=np.int32),
        block_base=np.asarray(b_base, dtype=np.int32),
        block_count=np.asarray(b_count, dtype=np.int32),
        block_doc_bits=np.asarray(b_dbits, dtype=np.int32),
        block_freq_bits=np.asarray(b_fbits, dtype=np.int32),
        block_word_off=np.asarray(b_woff, dtype=np.int32),
        block_max_freq=np.asarray(b_maxf, dtype=np.int32),
        block_max_norm=np.asarray(b_maxn, dtype=np.int32),
        block_entry_start=np.asarray(b_estart, dtype=np.int64),
        packed=packed,
        sum_total_tf=int(total_tf.sum()),
        sum_doc_freq=int(doc_freq.sum()),
        max_window_words=max_window,
    )

    if with_positions:
        pos_start = np.zeros(len(pos_lists) + 1, dtype=np.int64)
        np.cumsum(pos_counts, out=pos_start[1:])
        pp.pos_start = pos_start
        pp.positions = (
            np.concatenate(pos_lists).astype(np.int32)
            if pos_lists
            else np.zeros(0, dtype=np.int32)
        )
    return pp


def build_packed_postings_csr(
    terms: List[str],
    entry_start: np.ndarray,  # int64 [T+1] CSR into docs/freqs
    docs: np.ndarray,  # int32/int64 [NE] ascending per term
    freqs: np.ndarray,  # int32/int64 [NE]
    pos_start: Optional[np.ndarray] = None,  # int64 [NE+1]
    positions: Optional[np.ndarray] = None,  # int32 [NP]
    norms: Optional[np.ndarray] = None,
) -> PackedPostings:
    """Fully vectorized packer over CSR postings (no per-term Python loop).

    This is the flush hot path fed by the native (C++) accumulator: every
    per-block quantity (bit widths, word offsets, maxima) is a segmented
    numpy reduction, and the bit-packing itself is one scatter-add of
    shifted values into the shared word stream — the same math as
    ``pack_u32`` applied to all blocks at once.
    """
    T = len(terms)
    entry_start = np.asarray(entry_start, dtype=np.int64)
    docs = np.asarray(docs, dtype=np.int64)
    freqs = np.asarray(freqs, dtype=np.int64)
    NE = len(docs)
    df = np.diff(entry_start)

    if NE == 0 or T == 0:
        return build_packed_postings({}, None, norms)

    try:
        from diagon_tpu.native import _native as _nat
    except Exception:  # pragma: no cover
        _nat = None
    if _nat is not None and hasattr(_nat, "pack_blocks"):
        return _pack_blocks_native(
            _nat, terms, entry_start, docs, freqs, pos_start, positions,
            norms,
        )

    # --- entry -> term / block mapping (all vectorized) -----------------
    ent_term = np.repeat(np.arange(T, dtype=np.int64), df)
    ent_pos_in_term = np.arange(NE, dtype=np.int64) - entry_start[ent_term]
    ent_block_in_term = ent_pos_in_term >> 7  # // BLOCK_SIZE
    blocks_per_term = (df + BLOCK_SIZE - 1) >> 7
    block_start = np.zeros(T + 1, dtype=np.int32)
    np.cumsum(blocks_per_term, out=block_start[1:])
    NB = int(block_start[T])
    ent_block = (block_start[ent_term] + ent_block_in_term).astype(np.int64)
    ent_lane = ent_pos_in_term & (BLOCK_SIZE - 1)

    # first entry of each block
    is_first = ent_lane == 0
    first_idx = np.nonzero(is_first)[0]  # [NB] ascending
    block_count = np.minimum(
        df[ent_term[first_idx]] - ent_pos_in_term[first_idx], BLOCK_SIZE
    ).astype(np.int32)
    block_term = ent_term[first_idx].astype(np.int32)
    block_base = docs[first_idx].astype(np.int32)
    block_entry_start = np.zeros(NB + 1, dtype=np.int64)
    block_entry_start[:NB] = first_idx
    block_entry_start[NB] = NE

    # --- deltas ----------------------------------------------------------
    deltas = np.empty(NE, dtype=np.int64)
    deltas[0] = 0
    deltas[1:] = docs[1:] - docs[:-1]
    deltas[first_idx] = 0  # first lane of each block

    # --- per-block maxima via reduceat ------------------------------------
    red = first_idx  # segment starts
    block_max_delta = np.maximum.reduceat(deltas, red)
    block_max_freq_arr = np.maximum.reduceat(freqs, red).astype(np.int32)
    if norms is not None:
        block_max_norm = np.maximum.reduceat(
            norms[docs].astype(np.int64), red
        ).astype(np.int32)
    else:
        block_max_norm = np.full(NB, 127, dtype=np.int32)

    bl = np.vectorize(lambda m: max(1, int(m).bit_length()), otypes=[np.int64])
    block_doc_bits = np.maximum(
        1, np.where(block_max_delta > 0,
                    np.ceil(np.log2(block_max_delta + 1)).astype(np.int64), 1)
    )
    # log2-based width can undershoot on exact powers; verify and fix:
    under = block_max_delta >= (np.int64(1) << block_doc_bits)
    block_doc_bits[under] += 1
    block_freq_bits = np.maximum(
        1, np.where(block_max_freq_arr > 0,
                    np.ceil(np.log2(block_max_freq_arr.astype(np.int64) + 1)).astype(np.int64), 1)
    )
    under = block_max_freq_arr >= (np.int64(1) << block_freq_bits)
    block_freq_bits[under] += 1
    # all-freq-1 blocks omit the freq section (fbits == 0)
    block_freq_bits[block_max_freq_arr == 1] = 0

    # --- word layout -------------------------------------------------------
    cnt64 = block_count.astype(np.int64)
    dwords = (cnt64 * block_doc_bits + 31) >> 5
    fwords = (cnt64 * block_freq_bits + 31) >> 5
    block_words = dwords + fwords
    block_word_off = np.zeros(NB, dtype=np.int64)
    np.cumsum(block_words[:-1], out=block_word_off[1:])
    total_words = int(block_words.sum())

    max_window = int(
        (
            (BLOCK_SIZE * block_doc_bits + 31) // 32
            + (BLOCK_SIZE * block_freq_bits + 31) // 32
        ).max()
    )

    # --- vectorized bit packing (same math as pack_u32, all blocks) --------
    words = np.zeros(total_words + max_window + 2, dtype=np.uint64)

    nwords_alloc = len(words)

    def scatter_pack(values, bits_per_block, base_word):
        vals = values.astype(np.uint64)
        bits_e = bits_per_block[ent_block].astype(np.uint64)
        bitpos = ent_lane.astype(np.uint64) * bits_e
        widx = (base_word[ent_block] + (bitpos >> np.uint64(5))).astype(np.int64)
        shift = bitpos & np.uint64(31)
        lo = (vals << shift) & np.uint64(0xFFFFFFFF)
        hi = np.where(shift == 0, np.uint64(0),
                      vals >> (np.uint64(32) - shift))
        # zero-width sections (all-freq-1 blocks) write nothing
        zero = bits_e == 0
        if zero.any():
            lo = np.where(zero, np.uint64(0), lo)
            hi = np.where(zero, np.uint64(0), hi)
        # bincount instead of np.add.at (~20x faster); word sums < 2^32 are
        # exact in the float64 accumulation.
        idx = np.concatenate([widx, widx + 1])
        w = np.concatenate([lo, hi]).astype(np.float64)
        sums = np.bincount(idx, weights=w, minlength=nwords_alloc)
        words[:] += sums.astype(np.uint64)

    scatter_pack(deltas, block_doc_bits, block_word_off)
    scatter_pack(freqs, block_freq_bits, block_word_off + dwords)
    packed = words[: total_words + max_window + 1].astype(np.uint32)

    doc_freq = df.astype(np.int32)
    total_tf = np.zeros(T, dtype=np.int64)
    np.add.at(total_tf, ent_term, freqs)

    pp = PackedPostings(
        terms=list(terms),
        block_start=block_start,
        doc_freq=doc_freq,
        total_tf=total_tf,
        block_term=block_term,
        block_base=block_base,
        block_count=block_count,
        block_doc_bits=block_doc_bits.astype(np.int32),
        block_freq_bits=block_freq_bits.astype(np.int32),
        block_word_off=block_word_off.astype(np.int32),
        block_max_freq=block_max_freq_arr,
        block_max_norm=block_max_norm,
        block_entry_start=block_entry_start,
        packed=packed,
        sum_total_tf=int(freqs.sum()),
        sum_doc_freq=int(NE),
        max_window_words=max_window,
    )
    if pos_start is not None:
        pp.pos_start = np.asarray(pos_start, dtype=np.int64)
        pp.positions = (
            np.asarray(positions, dtype=np.int32)
            if positions is not None and len(positions)
            else np.zeros(0, dtype=np.int32)
        )
    return pp


def _pack_blocks_native(
    _nat, terms, entry_start, docs, freqs, pos_start, positions, norms
) -> PackedPostings:
    """C++ packer (native/_native.cpp pack_blocks) — bit-identical output
    to the numpy path below, one pass on one core (this host's single slow
    core makes the numpy bincount/scatter version the flush bottleneck)."""
    docs32 = np.ascontiguousarray(docs, dtype=np.int32)
    freqs32 = np.ascontiguousarray(freqs, dtype=np.int32)
    norms_b = (
        np.ascontiguousarray(norms, dtype=np.uint8).tobytes()
        if norms is not None
        else b""
    )
    (
        block_start, b_term, b_base, b_count, b_dbits, b_fbits, b_woff,
        b_maxf, b_maxn, b_estart, packed, max_window, doc_freq, total_tf,
    ) = _nat.pack_blocks(
        np.ascontiguousarray(entry_start, dtype=np.int64).tobytes(),
        docs32.tobytes(),
        freqs32.tobytes(),
        norms_b,
    )
    pp = PackedPostings(
        terms=list(terms),
        block_start=np.frombuffer(block_start, np.int32),
        doc_freq=np.frombuffer(doc_freq, np.int32),
        total_tf=np.frombuffer(total_tf, np.int64),
        block_term=np.frombuffer(b_term, np.int32),
        block_base=np.frombuffer(b_base, np.int32),
        block_count=np.frombuffer(b_count, np.int32),
        block_doc_bits=np.frombuffer(b_dbits, np.int32),
        block_freq_bits=np.frombuffer(b_fbits, np.int32),
        block_word_off=np.frombuffer(b_woff, np.int32),
        block_max_freq=np.frombuffer(b_maxf, np.int32),
        block_max_norm=np.frombuffer(b_maxn, np.int32),
        block_entry_start=np.frombuffer(b_estart, np.int64),
        packed=np.frombuffer(packed, np.uint32),
        sum_total_tf=int(np.frombuffer(total_tf, np.int64).sum()),
        sum_doc_freq=int(len(docs32)),
        max_window_words=int(max_window),
    )
    if pos_start is not None:
        pp.pos_start = np.asarray(pos_start, dtype=np.int64)
        pp.positions = (
            np.asarray(positions, dtype=np.int32)
            if positions is not None and len(positions)
            else np.zeros(0, dtype=np.int32)
        )
    return pp


def decode_all_numpy(pp: PackedPostings) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized full decode -> (docs int32 [NE], freqs int32 [NE]) in
    segment posting order (term-major, docid ascending).

    Used at device-load time to materialize the flat posting arrays the
    tile-grid scoring engine gathers from (the bit-packed form stays the
    storage format).
    """
    NB = pp.num_blocks
    if NB == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    words = np.concatenate(
        [pp.packed.astype(np.uint64), np.zeros(1, np.uint64)]
    )
    counts = pp.block_count.astype(np.int64)
    NE = int(pp.block_entry_start[NB])

    ent_block = np.repeat(np.arange(NB, dtype=np.int64), counts)
    ent_lane = (
        np.arange(NE, dtype=np.int64) - pp.block_entry_start[ent_block]
    )

    def unpack(bits_per_block, base_word):
        bits_e = bits_per_block[ent_block].astype(np.uint64)
        bitpos = ent_lane.astype(np.uint64) * bits_e
        widx = (base_word[ent_block].astype(np.uint64) + (bitpos >> np.uint64(5))).astype(np.int64)
        shift = bitpos & np.uint64(31)
        lo = words[widx] >> shift
        hi = np.where(
            shift == 0, np.uint64(0), words[widx + 1] << (np.uint64(32) - shift)
        )
        mask = (np.uint64(1) << bits_e) - np.uint64(1)
        return ((lo | hi) & mask).astype(np.int64)

    dbits = pp.block_doc_bits.astype(np.int64)
    deltas = unpack(dbits, pp.block_word_off.astype(np.int64))
    # per-block inclusive prefix sum of deltas: global cumsum minus the
    # cumsum value at each block start
    cs = np.cumsum(deltas)
    first_idx = pp.block_entry_start[:NB]
    cs_at_start = cs[first_idx]
    docs = (
        pp.block_base[ent_block].astype(np.int64)
        + cs
        - cs_at_start[ent_block]
    )

    dwords = (counts * dbits + 31) >> 5
    fbits = pp.block_freq_bits.astype(np.int64)
    freqs = unpack(fbits, pp.block_word_off.astype(np.int64) + dwords)
    # fbits == 0 encodes an all-freq-1 block (no freq section)
    freqs = np.where(fbits[ent_block] == 0, 1, freqs)
    return docs.astype(np.int32), freqs.astype(np.int32)


def decode_block_numpy(pp: PackedPostings, b: int) -> Tuple[np.ndarray, np.ndarray]:
    """Oracle decoder for one block -> (docids, freqs). Tests only."""
    from diagon_tpu.codecs.bitpack import unpack_u32_numpy

    count = int(pp.block_count[b])
    db = int(pp.block_doc_bits[b])
    fb = int(pp.block_freq_bits[b])
    off = int(pp.block_word_off[b])
    dw = words_for(count, db)
    deltas = unpack_u32_numpy(pp.packed[off : off + dw], db, count)
    if fb == 0:  # all-freq-1 block: no freq section
        freqs = np.ones(count, dtype=np.uint32)
    else:
        fw = words_for(count, fb)
        freqs = unpack_u32_numpy(
            pp.packed[off + dw : off + dw + fw], fb, count
        )
    docs = int(pp.block_base[b]) + np.cumsum(deltas.astype(np.int64))
    return docs.astype(np.int32), freqs.astype(np.int32)
