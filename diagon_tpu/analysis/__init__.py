"""Text analysis: tokenizers, token filters, analyzers.

Accelerator-native equivalent of the reference's analysis layer
(``src/core/include/analysis/``, SURVEY.md section 2.5). Tokenization is a
host-side concern (strings never reach the device); the hot ASCII path has a
C++ implementation in ``diagon_tpu/native`` with this pure-Python fallback.
"""

from diagon_tpu.analysis.tokenizers import (  # noqa: F401
    standard_tokenize,
    whitespace_tokenize,
    keyword_tokenize,
    cjk_bigram_tokenize,
    StandardTokenizer,
    WhitespaceTokenizer,
    KeywordTokenizer,
    CJKBigramTokenizer,
)
from diagon_tpu.analysis.filters import (  # noqa: F401
    LowercaseFilter,
    StopFilter,
    SynonymFilter,
    ASCIIFoldingFilter,
    ENGLISH_STOP_WORDS,
    CHINESE_STOP_WORDS,
)
from diagon_tpu.analysis.analyzer import (  # noqa: F401
    Analyzer,
    CompositeAnalyzer,
    StandardAnalyzer,
    WhitespaceAnalyzer,
    KeywordAnalyzer,
    EnglishAnalyzer,
    SimpleAnalyzer,
    SearchAnalyzer,
    MultilingualAnalyzer,
    ChineseAnalyzer,
    analyzer_for_name,
)
