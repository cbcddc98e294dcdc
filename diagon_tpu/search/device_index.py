"""Device-resident segment index.

Moves a flushed :class:`SegmentData`'s packed arrays into device memory
once; queries then run entirely on device. This is the device analogue of
the reference's mmap'd zero-copy segment files (``MMapDirectory.h``): the
packed word stream IS the in-memory format, no per-query decompression
state.

The term dictionary stays host-side as a Python dict (term -> term_id): term
lookup is a few hundred nanoseconds per query term and strings don't belong
on device. This replaces the reference's FST walk
(``util/PackedFST.h:16-48``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from diagon_tpu.index.segment import SegmentData, SegmentFieldData
from diagon_tpu.search.bm25 import BM25Similarity


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass
class DeviceField:
    """One field's device arrays + host term dict."""

    # host
    term_ids: Dict[str, int]
    doc_freq: np.ndarray  # host copy for idf/plan computation
    block_start: np.ndarray  # host int32 [T+1]
    sum_total_tf: int
    doc_count_with_field: int
    window_words: int
    num_blocks: int
    with_positions: bool
    max_freq: int  # max term freq in the field (sizes the BM25 tf table)

    # device
    packed: jnp.ndarray  # uint32 [W]
    block_base: jnp.ndarray  # int32 [NB]
    block_count: jnp.ndarray  # int32 [NB]
    block_doc_bits: jnp.ndarray  # int32 [NB]
    block_freq_bits: jnp.ndarray  # int32 [NB]
    block_word_off: jnp.ndarray  # int32 [NB]
    block_term: jnp.ndarray  # int32 [NB]
    block_max_freq: jnp.ndarray  # int32 [NB]
    block_max_norm: jnp.ndarray  # int32 [NB]
    block_entry_start: jnp.ndarray  # int32 [NB]
    norms: jnp.ndarray  # int32 [num_docs] (uint8 widened for gathers)

    # positions (None if field indexed without positions). Device upload
    # is LAZY (ensure_positions): the position arrays are ~NP*4 bytes —
    # at 10M docs ~5 GB of HBM that only phrase queries touch; eager
    # upload OOM'd the 10M scale run next to the 6 GB heavy bank.
    pos_start: Optional[jnp.ndarray] = None  # int32 [NE+1] (device, lazy)
    positions: Optional[jnp.ndarray] = None  # int32 [NP] (device, lazy)
    max_positions_per_entry: int = 0
    pos_start_host: Optional[object] = None  # np int32 [NE+1]
    positions_host: Optional[object] = None  # np int32 [NP]
    _pos_device: Optional[object] = None
    _pos_pp: Optional[object] = None  # PackedPostings w/ (lazy) positions

    @property
    def with_position_data(self) -> bool:
        return self.pos_start_host is not None or self._pos_pp is not None

    def ensure_positions(self) -> None:
        """Upload position arrays to the device on first phrase use.
        Two lazy layers: the HOST arrays may themselves still be a
        deferred bundle decode (PackedPostings.pos_loader — minutes of
        one-core CPU at 10M docs), forced here, then uploaded."""
        if self.pos_start_host is None and self._pos_pp is not None:
            pp = self._pos_pp
            pp.ensure_positions()
            if pp.pos_start is not None:
                self.pos_start_host = pp.pos_start.astype(np.int32)
                pos = pp.positions
                if len(pos) == 0:
                    pos = np.zeros(1, dtype=np.int32)
                self.positions_host = np.asarray(pos, dtype=np.int32)
                counts = np.diff(pp.pos_start)
                self.max_positions_per_entry = (
                    int(counts.max()) if len(counts) else 0
                )
        if self.pos_start is None and self.pos_start_host is not None:
            self.pos_start = jax.device_put(
                jnp.asarray(self.pos_start_host), self._pos_device
            )
            self.positions = jax.device_put(
                jnp.asarray(self.positions_host), self._pos_device
            )

    def term_id(self, term: str) -> int:
        return self.term_ids.get(term, -1)


@dataclass
class DeviceSegment:
    """A segment resident on device, searchable by the engine."""

    name: str
    num_docs: int
    num_docs_pad: int
    fields: Dict[str, DeviceField]
    live_docs: Optional[jnp.ndarray]  # bool [num_docs_pad] or None
    source: Optional[SegmentData] = None  # host copy (stored fields, etc.)

    def field(self, name: str) -> DeviceField:
        f = self.fields.get(name)
        if f is None:
            raise KeyError(f"field {name!r} is not indexed in segment {self.name}")
        return f


def _pad_blocks(arr: np.ndarray, nb_pad: int, fill=0) -> np.ndarray:
    if len(arr) == nb_pad:
        return arr
    out = np.full(nb_pad, fill, dtype=arr.dtype)
    out[: len(arr)] = arr
    return out


def load_field(fd: SegmentFieldData, num_docs_pad: int, device=None) -> DeviceField:
    pp = fd.postings
    nb = pp.num_blocks
    nb_pad = max(8, _round_up(nb, 8))

    def dev(x):
        return jax.device_put(jnp.asarray(x), device)

    norms32 = np.zeros(num_docs_pad, dtype=np.int32)
    norms32[: len(fd.norms)] = fd.norms.astype(np.int32)

    field = DeviceField(
        term_ids={t: i for i, t in enumerate(pp.terms)},
        doc_freq=pp.doc_freq.copy(),
        block_start=pp.block_start.copy(),
        sum_total_tf=pp.sum_total_tf,
        doc_count_with_field=pp.doc_count_with_field,
        window_words=pp.max_window_words,
        num_blocks=nb,
        with_positions=fd.with_positions,
        max_freq=int(pp.block_max_freq.max()) if nb else 1,
        packed=dev(pp.packed.view(np.uint32)),
        block_base=dev(_pad_blocks(pp.block_base, nb_pad)),
        block_count=dev(_pad_blocks(pp.block_count, nb_pad)),
        block_doc_bits=dev(_pad_blocks(pp.block_doc_bits, nb_pad, fill=1)),
        block_freq_bits=dev(_pad_blocks(pp.block_freq_bits, nb_pad, fill=1)),
        block_word_off=dev(_pad_blocks(pp.block_word_off, nb_pad)),
        block_term=dev(_pad_blocks(pp.block_term, nb_pad, fill=-1)),
        block_max_freq=dev(_pad_blocks(pp.block_max_freq, nb_pad)),
        block_max_norm=dev(_pad_blocks(pp.block_max_norm, nb_pad)),
        block_entry_start=dev(
            _pad_blocks(pp.block_entry_start[:-1].astype(np.int32), nb_pad)
        ),
        norms=dev(norms32),
    )

    if pp.has_positions:
        # host decode AND device upload both deferred to first phrase
        # use (DeviceField.ensure_positions)
        field._pos_pp = pp
        field._pos_device = device
    return field


def load_segment(seg: SegmentData, device=None, keep_source: bool = True) -> DeviceSegment:
    """Upload a segment's search structures to the device.

    Doc padding is 1024: eight 128-doc tiles, the phase-1 kernel's doc
    block (ops/pallas/approx_pass.py)."""
    num_docs_pad = max(1024, _round_up(seg.num_docs, 1024))
    fields = {
        name: load_field(fd, num_docs_pad, device)
        for name, fd in seg.fields.items()
    }
    live = None
    if seg.live_docs is not None:
        lv = np.zeros(num_docs_pad, dtype=bool)
        lv[: seg.num_docs] = seg.live_docs
        live = jax.device_put(jnp.asarray(lv), device)
    return DeviceSegment(
        name=seg.name,
        num_docs=seg.num_docs,
        num_docs_pad=num_docs_pad,
        fields=fields,
        live_docs=live,
        source=seg if keep_source else None,
    )


def collection_stats(segments, field: str, max_doc: int):
    """(idf-ready stats) aggregated across device segments, mirroring
    TermQuery.cpp:184-260: sums of per-segment sumTotalTermFreq, avgdl from
    float32 division, docCount = maxDoc."""
    stt = 0
    for ds in segments:
        f = ds.fields.get(field)
        if f is not None and f.sum_total_tf > 0:
            stt += f.sum_total_tf
    if stt <= 0:
        stt = max_doc * 10
    return BM25Similarity.avg_field_length(stt, max_doc)
