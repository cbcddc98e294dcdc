"""Fixed-width bit packing into uint32 word streams.

The accelerator-native replacement for the reference's PFOR/StreamVByte encodings
(``util/BitPacking.h:11-44``, ``util/StreamVByte.h``): values are packed
little-endian at a fixed bits-per-value within each section; a value may
straddle a word boundary, in which case its low bits live in word ``i`` and
its high bits in word ``i+1``. This layout decodes with two gathers + shifts
+ masks — branch-free, fully vectorizable on the device, no data-dependent
lengths (the property the reference's byte-oriented codecs lack).

Numpy encode lives here; the JAX/device decode lives in
``diagon_tpu/ops/bitpack_ops.py`` and must match bit-for-bit
(tested by round-trip tests).
"""

from __future__ import annotations

import numpy as np


def bits_needed(max_value: int) -> int:
    """Minimum bits to represent values in [0, max_value]. At least 1."""
    if max_value < 0:
        raise ValueError("bit packing requires non-negative values")
    return max(1, int(max_value).bit_length())


def pack_u32(values: np.ndarray, bits: int) -> np.ndarray:
    """Pack non-negative ints into a little-endian uint32 word stream.

    Returns exactly ``ceil(len(values) * bits / 32)`` words.
    """
    values = np.asarray(values, dtype=np.uint64)
    n = len(values)
    if n == 0:
        return np.zeros(0, dtype=np.uint32)
    if bits < 1 or bits > 32:
        raise ValueError(f"bits must be in [1, 32], got {bits}")
    if values.max() >= (1 << bits):
        raise ValueError(f"value {values.max()} does not fit in {bits} bits")

    nwords = (n * bits + 31) // 32
    words = np.zeros(nwords + 1, dtype=np.uint64)  # +1 slack for straddle

    bitpos = np.arange(n, dtype=np.uint64) * np.uint64(bits)
    widx = (bitpos >> np.uint64(5)).astype(np.int64)
    shift = bitpos & np.uint64(31)

    lo = (values << shift) & np.uint64(0xFFFFFFFF)
    hi = values >> (np.uint64(32) - shift)  # 0 when shift == 0 and bits <= 32
    # When shift == 0 the >> 32 is UB-ish in C but numpy uint64 handles it as
    # shift-by-32 of a value < 2^32 => 0 only if bits < 32; force it:
    hi = np.where(shift == 0, np.uint64(0), hi)

    np.add.at(words, widx, lo)
    np.add.at(words, widx + 1, hi)
    return words[:nwords].astype(np.uint32)


def unpack_u32_numpy(words: np.ndarray, bits: int, count: int) -> np.ndarray:
    """Reference numpy decoder (oracle for the device kernel)."""
    words = np.asarray(words, dtype=np.uint64)
    # Slack word so straddle reads never go out of bounds.
    words = np.concatenate([words, np.zeros(1, dtype=np.uint64)])
    i = np.arange(count, dtype=np.uint64)
    bitpos = i * np.uint64(bits)
    widx = (bitpos >> np.uint64(5)).astype(np.int64)
    shift = bitpos & np.uint64(31)
    lo = words[widx] >> shift
    hi = np.where(
        shift == 0, np.uint64(0), words[widx + 1] << (np.uint64(32) - shift)
    )
    mask = np.uint64((1 << bits) - 1)
    return ((lo | hi) & mask).astype(np.uint32)


def words_for(count: int, bits: int) -> int:
    return (count * bits + 31) // 32
