"""JAX bit-unpacking of packed posting blocks.

Device-side decoder for the format in ``diagon_tpu/codecs/bitpack.py``:
values at per-block fixed width, little-endian within uint32 words, values
may straddle word boundaries. The decode of lane ``i`` at width ``bits`` is

    bitpos = word_base*32 + i*bits
    lo = window[bitpos >> 5] >> (bitpos & 31)
    hi = window[(bitpos >> 5) + 1] << (32 - (bitpos & 31))   (0 if aligned)
    value = (lo | hi) & ((1 << bits) - 1)

— two in-window gathers + shifts + mask, branch-free and identical for all
128 lanes of a block: exactly the shape vector hardware wants (compare the
reference's sequential StreamVByte control-byte walk, StreamVByte.h:15-35).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def unpack_lanes(
    window: jnp.ndarray,  # uint32 [B, W] gathered words per block
    bits: jnp.ndarray,  # int32 [B] bits-per-value per block
    word_base: jnp.ndarray,  # int32 [B] first word of the section in-window
    num_lanes: int = 128,
) -> jnp.ndarray:
    """Decode ``num_lanes`` values per block. Returns int32 [B, num_lanes].

    Lanes beyond a block's logical count decode garbage (from the next
    block's words); callers mask by count.
    """
    B, W = window.shape
    bits_u = bits.astype(jnp.uint32)[:, None]  # [B,1]
    lane = jax.lax.broadcasted_iota(jnp.uint32, (1, num_lanes), 1)  # [1,L]

    bitpos = word_base.astype(jnp.uint32)[:, None] * jnp.uint32(32) + lane * bits_u
    widx = (bitpos >> jnp.uint32(5)).astype(jnp.int32)  # [B,L]
    shift = bitpos & jnp.uint32(31)

    widx0 = jnp.minimum(widx, W - 1)
    widx1 = jnp.minimum(widx + 1, W - 1)
    w0 = jnp.take_along_axis(window, widx0, axis=1)
    w1 = jnp.take_along_axis(window, widx1, axis=1)

    lo = w0 >> shift
    hi = jnp.where(
        shift == 0,
        jnp.uint32(0),
        w1 << (jnp.uint32(32) - shift),
    )
    # bits == 0 is a valid width (empty section, e.g. an all-freq-1 freq
    # section): decode as 0 (callers substitute the implied value)
    mask = jnp.where(
        bits_u == 0,
        jnp.uint32(0),
        jnp.uint32(0xFFFFFFFF) >> (jnp.uint32(32) - jnp.maximum(bits_u, 1)),
    )
    return ((lo | hi) & mask).astype(jnp.int32)


def gather_windows(
    packed: jnp.ndarray,  # uint32 [W_total] shared word stream
    word_off: jnp.ndarray,  # int32 [B] per-block word offsets
    window_words: int,
) -> jnp.ndarray:
    """Gather a fixed-size word window per block: uint32 [B, window_words]."""
    idx = word_off[:, None] + jnp.arange(window_words, dtype=jnp.int32)[None, :]
    idx = jnp.clip(idx, 0, packed.shape[0] - 1)
    return packed[idx]


def decode_doc_blocks(
    packed: jnp.ndarray,
    word_off: jnp.ndarray,  # int32 [B]
    base: jnp.ndarray,  # int32 [B]
    count: jnp.ndarray,  # int32 [B]
    doc_bits: jnp.ndarray,  # int32 [B]
    freq_bits: jnp.ndarray,  # int32 [B]
    window_words: int,
):
    """Decode gathered posting blocks -> (docids, freqs, valid) each [B,128].

    Invalid lanes have docids clamped into range but ``valid`` False.
    """
    window = gather_windows(packed, word_off, window_words)

    deltas = unpack_lanes(window, doc_bits, jnp.zeros_like(word_off))
    docids = base[:, None] + jnp.cumsum(deltas, axis=1, dtype=jnp.int32)

    # Freq section starts word-aligned after ceil(count*doc_bits/32) words.
    dwords = (count * doc_bits + 31) >> 5
    freqs = unpack_lanes(window, freq_bits, dwords)
    # freq_bits == 0 encodes an all-freq-1 block (no freq section on disk)
    freqs = jnp.where(freq_bits[:, None] == 0, jnp.int32(1), freqs)

    lane = jax.lax.broadcasted_iota(jnp.int32, (1, 128), 1)
    valid = lane < count[:, None]
    return docids, freqs, valid
