"""Search layer: queries, BM25, device execution, collectors.

Equivalent of the reference's ``diagon/search/`` (SURVEY.md section 2.7),
re-designed block-at-a-time for vectorized device code instead of doc-at-a-time
iterator chains.
"""

from diagon_tpu.search.bm25 import BM25Similarity, BM25Params  # noqa: F401
from diagon_tpu.search.query import (  # noqa: F401
    Query,
    TermQuery,
    BooleanQuery,
    BooleanClause,
    Occur,
    PhraseQuery,
    MatchAllDocsQuery,
    DoubleRangeQuery,
    NumericRangeQuery,
    PointRangeQuery,
)
from diagon_tpu.search.topdocs import TopDocs, ScoreDoc  # noqa: F401

try:  # pragma: no cover - available once the device engine is built
    from diagon_tpu.search.searcher import IndexSearcher  # noqa: F401
except ImportError:
    pass
