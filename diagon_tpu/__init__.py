"""diagon_tpu — a search framework in JAX (inverted index + columnar store).

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
model-collapse/diagon (a C++ Lucene-style search library, see
/root/reference): Lucene-style inverted index with BM25 ranking, boolean /
phrase / range queries, ClickHouse-style columnar granule storage with skip
indexes, and a segment-based write/commit/merge lifecycle.

Architecture (accelerator-first, not a port):

- **Term dictionary**: host-side hash table (term -> term_id) instead of the
  reference's FST/trie (reference: ``src/core/include/diagon/util/PackedFST.h``).
- **Postings**: fixed-width bit-packed 128-doc blocks stored as dense uint32
  word arrays resident in device memory, decoded by vectorized shift/mask
  kernels (reference: StreamVByte / PFOR streams,
  ``src/core/include/diagon/util/BitPacking.h``).
- **Scoring**: dense per-term score rows summed in oracle order, with a
  two-phase pruned batch path and on-device top-k, instead of
  doc-at-a-time Block-Max WAND heaps (reference:
  ``src/core/include/diagon/search/WANDScorer.h``).
- **Block-max pruning**: a dense ``[block]`` max-impact table prunes blocks
  *before* the gather — the moral equivalent of the reference's ``.skp``
  skip entries (``Lucene104PostingsWriter.h``).
- **Parallelism**: segments shard across a ``jax.sharding.Mesh``; per-device
  top-k results merge with ``all_gather`` (the reference is
  single-process; its per-leaf search loop ``IndexSearcher.cpp:76`` is the
  seam this replaces).

Public API mirrors the reference's layer map (SURVEY.md section 1):
``analysis`` / ``document`` / ``index`` / ``codecs`` / ``store`` / ``search``
/ ``columnar`` / ``sparse`` / ``parallel`` / ``observability``.
"""

__version__ = "0.1.0"

from diagon_tpu.document.document import (  # noqa: F401
    Document,
    Field,
    TextField,
    StringField,
    StoredField,
    NumericDocValuesField,
    SortedDocValuesField,
    SortedNumericDocValuesField,
    SortedSetDocValuesField,
    BinaryDocValuesField,
    LongPointField,
    DoubleDocValuesField,
    DoublePointField,
    IndexOptions,
    FieldType,
)
