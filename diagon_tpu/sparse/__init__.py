"""Sparse-vector search (learned-sparse / SPLADE-style retrieval).

Equivalent of the reference's sparse layer (SURVEY.md section 2.9:
``SindiIndex`` — 128-doc blocks with per-block max weight for WAND pruning
and SIMD accumulation — and ``QBlockIndex`` — quantized block index with
gain-based block selection). Accelerator redesign: quantized weights ride the same
packed 128-doc block format as text postings, and scoring reuses the
boolean engine's block kernel with a linear dequantization LUT — the
sparse dot product IS a disjunctive weighted term query.
"""

from diagon_tpu.sparse.vector import SparseVector  # noqa: F401
from diagon_tpu.sparse.index import SparseIndex, SparseSearcher  # noqa: F401
