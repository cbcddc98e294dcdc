"""bits_hits vs a numpy oracle: exact hit counts from presence bitmaps
for pure-OR and general (min_should<=1) boolean batches."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from diagon_tpu.search.row_engine import (  # noqa: E402
    MODE_DEAD,
    MODE_REQ,
    MODE_SHO,
    bits_hits,
)


def _pack_rows(rows_bool):
    """[N, D] bool -> [N, D/32] u32, bit d%32 of word d/32."""
    N, D = rows_bool.shape
    v = rows_bool.astype(np.uint32).reshape(N, D // 32, 32)
    return (v << np.arange(32, dtype=np.uint32)).sum(
        axis=-1, dtype=np.uint32
    )


def _oracle_hits(rows_bool, cidx, cflags, qmode):
    Q, Tq = cidx.shape
    D = rows_bool.shape[1]
    out = np.zeros(Q, np.int32)
    for q in range(Q):
        if qmode[q] & MODE_DEAD:
            continue
        band = np.ones(D, bool)
        bor = np.zeros(D, bool)
        bneg = np.zeros(D, bool)
        for t in range(Tq):
            row = rows_bool[cidx[q, t]]
            fl = cflags[q, t]
            if fl & 2:
                band &= row
            if fl & 4:
                bor |= row
            if fl & 8:
                bneg |= row
        m = np.ones(D, bool)
        if qmode[q] & MODE_REQ:
            m &= band
        if qmode[q] & MODE_SHO:
            m &= bor
        m &= ~bneg
        out[q] = int(m.sum())
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_bits_hits_matches_numpy(seed):
    rng = np.random.Generator(np.random.PCG64(seed))
    D = 32 * 128 * 3  # 12288 docs -> W = 384 words
    U8 = 24
    Q, Tq = 64, 8
    rows = rng.random((U8, D)) < 0.08
    rows[0] = False  # row 0 = zero row
    bits = _pack_rows(rows)

    cidx = rng.integers(0, U8, (Q, Tq)).astype(np.int32)
    cflags = np.zeros((Q, Tq), np.int32)
    qmode = np.zeros(Q, np.int32)
    for q in range(Q):
        kind = q % 4
        if kind == 0:  # pure OR
            cflags[q] = 4
            qmode[q] = MODE_SHO
        elif kind == 1:  # MUST head + SHOULD tail, min_should 0
            cflags[q, 0] = 2
            cflags[q, 1:] = 4
            qmode[q] = MODE_REQ
        elif kind == 2:  # MUST + MUST_NOT
            cflags[q, :2] = 2
            cflags[q, 2] = 8
            cflags[q, 3:] = 4
            qmode[q] = MODE_REQ
        else:  # dead (absent required clause)
            cflags[q] = 4
            qmode[q] = MODE_DEAD
        # sprinkle padding clauses (cidx 0 + flags 0)
        cflags[q, Tq - 2 :] = np.where(
            cflags[q, Tq - 2 :] != 0, cflags[q, Tq - 2 :], 0
        )
    # padding clause: no flags, row 0
    cidx[:, Tq - 1] = 0
    cflags[:, Tq - 1] = 0

    want = _oracle_hits(rows, cidx, cflags, qmode)
    got = np.asarray(
        bits_hits(
            jnp.asarray(bits),
            jnp.asarray(cidx),
            jnp.asarray(cflags),
            jnp.asarray(qmode),
        )
    )
    np.testing.assert_array_equal(got, want)
