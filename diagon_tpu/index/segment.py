"""Immutable segment data + commit-point metadata.

``SegmentData`` is the flushed, immutable form of a segment: per-field packed
postings + norms, doc values, points, stored rows, live-docs bitmap. It is
the unit of search, merge, serialization (``diagon_tpu/store``) and device
residency (``diagon_tpu/search/device_index``).

``SegmentInfo``/``SegmentInfos`` mirror the reference's commit model
(``index/SegmentInfo.h:217-313``): a commit is an atomic generation file
(``segments_<gen>.json``) listing immutable per-segment artifact files.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Optional, Tuple

import numpy as np

from diagon_tpu.codecs.postings import PackedPostings, build_packed_postings
from diagon_tpu.document.document import DocValuesType
from diagon_tpu.index.memory_index import MemoryIndex


@dataclass
class SegmentFieldData:
    """One indexed field within a segment: postings + norms."""

    postings: PackedPostings
    norms: np.ndarray  # uint8 [num_docs]
    with_positions: bool = False


@dataclass
class DocValuesData:
    dv_type: DocValuesType
    docs: np.ndarray  # int32 [n] ascending
    # NUMERIC/SORTED_NUMERIC: int64 values; SORTED/SORTED_SET/BINARY:
    # ord int32 into ``ord_values`` (sorted unique byte strings).
    values: np.ndarray
    ord_values: Optional[List[bytes]] = None
    # multi-valued CSR for SORTED_NUMERIC / SORTED_SET
    value_start: Optional[np.ndarray] = None


@dataclass
class PointsData:
    """1-D numeric point index: value-sorted columns (the BKD replacement).

    The reference builds a 1-D BKD tree (``BKDWriter.h:22-58``); on the device the
    equivalent is simply the (value, docid) pairs sorted by value — range
    queries become two binary searches + a docid slice, vectorizable and
    mergeable by concatenation+sort.
    """

    values: np.ndarray  # int64 or float64 [n], ascending
    docs: np.ndarray  # int32 [n], parallel
    is_double: bool = False


@dataclass
class SegmentData:
    name: str
    num_docs: int
    fields: Dict[str, SegmentFieldData] = dc_field(default_factory=dict)
    doc_values: Dict[str, DocValuesData] = dc_field(default_factory=dict)
    points: Dict[str, PointsData] = dc_field(default_factory=dict)
    stored: List[Dict[str, object]] = dc_field(default_factory=list)
    # live-docs bitmap; None means all live (reference .liv)
    live_docs: Optional[np.ndarray] = None  # bool [num_docs]
    # per-field schema (reference FieldInfos); None for disk-loaded
    # segments (derive with field_infos.infos_from_segment)
    field_infos: Optional[object] = None

    @property
    def num_live_docs(self) -> int:
        if self.live_docs is None:
            return self.num_docs
        return int(self.live_docs.sum())

    def delete_document(self, doc_id: int) -> bool:
        if doc_id < 0 or doc_id >= self.num_docs:
            return False
        if self.live_docs is None:
            self.live_docs = np.ones(self.num_docs, dtype=bool)
        was_live = bool(self.live_docs[doc_id])
        self.live_docs[doc_id] = False
        return was_live


def flush_memory_index(mem: MemoryIndex, name: str) -> Optional[SegmentData]:
    """Flush the in-memory buffer into an immutable SegmentData.

    The analogue of ``DocumentsWriterPerThread::flush``
    (DocumentsWriterPerThread.cpp:488-766): norms first (block-max tables
    need them), then packed postings, doc values, points, stored rows.
    """
    if mem.num_docs == 0:
        return None

    seg = SegmentData(name=name, num_docs=mem.num_docs)
    seg.field_infos = mem.field_infos()

    for fname, fb in mem.fields.items():
        norms = mem.compute_norms(fname)
        nat = mem._native_arrays(fb)
        if nat is not None and not fb.postings:
            # pure native-buffer field: vectorized CSR packer (hot path)
            from diagon_tpu.codecs.postings import build_packed_postings_csr

            pp = build_packed_postings_csr(
                nat["terms"],
                nat["entry_start"],
                nat["docs"],
                nat["freqs"],
                nat["pos_start"] if fb.with_positions else None,
                nat["positions"] if fb.with_positions else None,
                norms,
            )
        elif nat is None and not fb.with_positions:
            # dict postings without positions -> CSR -> vectorized packer
            from diagon_tpu.codecs.postings import build_packed_postings_csr

            postings_arrays, _ = mem.field_term_arrays(fname)
            terms = sorted(postings_arrays.keys())
            entry_start = np.zeros(len(terms) + 1, dtype=np.int64)
            docs_l, freqs_l = [], []
            for i, t in enumerate(terms):
                d, f = postings_arrays[t]
                entry_start[i + 1] = entry_start[i] + len(d)
                docs_l.append(d)
                freqs_l.append(f)
            pp = build_packed_postings_csr(
                terms,
                entry_start,
                np.concatenate(docs_l) if docs_l else np.zeros(0, np.int64),
                np.concatenate(freqs_l) if freqs_l else np.zeros(0, np.int64),
                norms=norms,
            )
        else:
            postings_arrays, positions = mem.field_term_arrays(fname)
            pp = build_packed_postings(postings_arrays, positions, norms)
        pp.doc_count_with_field = fb.doc_count_with_field
        seg.fields[fname] = SegmentFieldData(
            postings=pp, norms=norms, with_positions=fb.with_positions
        )

    for fname, dv in mem.doc_values.items():
        docs = np.asarray(dv.docs, dtype=np.int32)
        if dv.dv_type in (DocValuesType.NUMERIC, DocValuesType.SORTED_NUMERIC):
            vals = np.asarray([int(v) for v in dv.values], dtype=np.int64)
            if dv.dv_type == DocValuesType.SORTED_NUMERIC:
                docs, vals, starts = _multi_value_csr(docs, vals, sort_vals=True)
                seg.doc_values[fname] = DocValuesData(
                    dv.dv_type, docs, vals, value_start=starts
                )
            else:
                seg.doc_values[fname] = DocValuesData(dv.dv_type, docs, vals)
        else:
            raw = [
                v.encode() if isinstance(v, str) else bytes(v) for v in dv.values
            ]
            uniq = sorted(set(raw))
            ord_map = {b: i for i, b in enumerate(uniq)}
            ords = np.asarray([ord_map[b] for b in raw], dtype=np.int64)
            if dv.dv_type == DocValuesType.SORTED_SET:
                docs, ords, starts = _multi_value_csr(docs, ords, sort_vals=True)
                seg.doc_values[fname] = DocValuesData(
                    dv.dv_type, docs, ords, ord_values=uniq, value_start=starts
                )
            else:
                seg.doc_values[fname] = DocValuesData(
                    dv.dv_type, docs, ords, ord_values=uniq
                )

    for fname, pb in mem.points.items():
        vals = np.asarray(
            pb.values, dtype=np.float64 if pb.is_double else np.int64
        )
        docs = np.asarray(pb.docs, dtype=np.int32)
        order = np.lexsort((docs, vals))
        seg.points[fname] = PointsData(
            values=vals[order], docs=docs[order], is_double=pb.is_double
        )

    seg.stored = list(mem.stored)
    return seg


def _multi_value_csr(
    docs: np.ndarray, vals: np.ndarray, sort_vals: bool
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Group duplicate (doc, value) rows into CSR (unique docs + offsets)."""
    uniq_docs, start_idx = np.unique(docs, return_index=True)
    order = np.argsort(docs, kind="stable")
    sorted_vals = vals[order]
    counts = np.bincount(
        np.searchsorted(uniq_docs, docs), minlength=len(uniq_docs)
    )
    starts = np.zeros(len(uniq_docs) + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    if sort_vals:
        out_vals = sorted_vals.copy()
        for i in range(len(uniq_docs)):
            s, e = starts[i], starts[i + 1]
            out_vals[s:e] = np.sort(sorted_vals[s:e])
        sorted_vals = out_vals
    return uniq_docs.astype(np.int32), sorted_vals, starts


@dataclass
class SegmentInfo:
    """Per-segment commit metadata (reference ``SegmentInfo.h``)."""

    name: str
    num_docs: int
    files: List[str] = dc_field(default_factory=list)
    del_count: int = 0
    diagnostics: Dict[str, str] = dc_field(default_factory=dict)

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "num_docs": self.num_docs,
            "files": self.files,
            "del_count": self.del_count,
            "diagnostics": self.diagnostics,
        }

    @staticmethod
    def from_json(d: dict) -> "SegmentInfo":
        return SegmentInfo(
            name=d["name"],
            num_docs=d["num_docs"],
            files=list(d.get("files", [])),
            del_count=int(d.get("del_count", 0)),
            diagnostics=dict(d.get("diagnostics", {})),
        )


@dataclass
class SegmentInfos:
    """The commit point: generation + list of segments (``segments_N``)."""

    generation: int = 0
    segments: List[SegmentInfo] = dc_field(default_factory=list)
    counter: int = 0  # next segment name counter

    def to_json(self) -> dict:
        return {
            "generation": self.generation,
            "counter": self.counter,
            "segments": [s.to_json() for s in self.segments],
        }

    @staticmethod
    def from_json(d: dict) -> "SegmentInfos":
        return SegmentInfos(
            generation=int(d["generation"]),
            counter=int(d.get("counter", 0)),
            segments=[SegmentInfo.from_json(s) for s in d["segments"]],
        )

    def total_docs(self) -> int:
        return sum(s.num_docs for s in self.segments)
