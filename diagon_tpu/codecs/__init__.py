"""Codecs: packed on-disk / in-HBM formats.

Accelerator-native replacement of the reference codec layer (SURVEY.md section 2.3).
Instead of variable-width byte streams (StreamVByte / PFOR,
``util/BitPacking.h``) decoded doc-at-a-time, every format here is a set of
dense, fixed-dtype arrays that can be memory-mapped from disk and
``jax.device_put`` into HBM unchanged, then decoded block-at-a-time by
vectorized shift/mask kernels.
"""

from diagon_tpu.codecs.bitpack import (  # noqa: F401
    pack_u32,
    unpack_u32_numpy,
    bits_needed,
)
from diagon_tpu.codecs.postings import (  # noqa: F401
    BLOCK_SIZE,
    PackedPostings,
    build_packed_postings,
)
