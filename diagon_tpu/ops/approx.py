"""Phase 1 of the pruned batch path: approximate scores -> tile maxima.

For every (query, 128-doc tile) the pruned executor needs the maximum
approximate score, and per query the EXACT live-match count. Both come
from products of the query-indicator matrices with the batch-compact
bf16 bank ([U8, D], U8 = the batch's clause rows):

- ``or``: one product ``a_sc_t^T . bank`` -> [Q, D] approximate scores;
  contributions are nonnegative, so ``approx > 0`` is the exact match
  mask.
- ``bool2`` (no MUST_NOT): the score product plus ONE presence product
  whose indicator carries ``rq*256 + sh`` per (row, query); the f32
  product decodes back to the exact required/should counts.
- ``bool``: the score product plus three presence products (required,
  should, must-not counts).

Presence is derived from the score bank (``bank > 0``), so one bank is
read. Counts of 0/1 products are exact in f32 (< 2^24), and bf16
products accumulate in f32, so the tile maximum is within the
``_APPROX_RELEPS`` bound of the exact score (see row_engine).

``approx_select_xla`` is the plain XLA form and the reference for the
GPU kernel in ``ops/pallas/approx_pass.py``; ``approx_select`` picks
between them — the single place the backend decides which runs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

LANE = 128
# bank rows per product step of the phase-1 kernel
KB = 64

# bytes of f32 product the plain form materializes per doc chunk; 32 MB
# (8k docs x 1024 queries for the pure-OR product) is L2-sized on the
# GPU, so most of the product need not reach device memory
CHUNK_BYTES = 32 << 20


def bank_rows(n: int, floor: int = 16) -> int:
    """Row count to build a compact bank at: a power of two >= ``floor``
    up to ``KB``, then a multiple of ``KB`` — the row counts the phase-1
    kernel steps through without padding the bank."""
    if n <= KB:
        return max(floor, 1 << max(0, n - 1).bit_length())
    return -(-n // KB) * KB


def _ct(a_t, b):
    """[K, Q]^T . [K, C] -> [Q, C] f32 (bf16 operands, f32 accumulate)."""
    return jax.lax.dot_general(
        a_t, b, dimension_numbers=(((0,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )


def _chunk(bank_c, live_c, a_sc_t, roles, params_t):
    """(tile max f32 [Q, n], hits i32 [Q]) for one doc chunk [U8, n*128]."""
    Q = a_sc_t.shape[1]
    n = bank_c.shape[1] // LANE
    ap = _ct(a_sc_t, bank_c).reshape(Q, n, LANE)
    lv = live_c.reshape(1, n, LANE) > 0
    if not roles:
        m = (ap > 0) & lv
        return ap.max(axis=2), m.sum(axis=(1, 2), dtype=jnp.int32)
    pres = jnp.where(bank_c > 0, 1.0, 0.0).astype(jnp.bfloat16)
    nreq = params_t[0][:, None, None]
    msm = params_t[1][:, None, None]
    if len(roles) == 1:
        cc = _ct(roles[0], pres).reshape(Q, n, LANE)
        rc = jnp.floor(cc * jnp.float32(1.0 / 256.0))
        oc = cc - rc * jnp.float32(256.0)
        m = (rc == nreq) & (oc >= msm) & (cc > 0) & lv
    else:
        rc, oc, nc = (_ct(r, pres).reshape(Q, n, LANE) for r in roles)
        m = (
            (rc == nreq) & (oc >= msm) & (nc == 0) & ((rc + oc) > 0) & lv
        )
    cnt = m.sum(axis=2, dtype=jnp.int32)  # [Q, n]
    tmax = jnp.where(cnt > 0, ap.max(axis=2), jnp.float32(-1.0))
    return tmax, cnt.sum(axis=1)


def approx_select_xla(bank, live, a_sc_t, roles=(), params_t=None, *,
                      chunk_bytes: int = CHUNK_BYTES):
    """Plain-XLA phase 1. ``bank`` bf16 [U8, D] (D a multiple of 128),
    ``live`` f32 [D], ``a_sc_t`` bf16 [U8, Q]; ``roles`` is () for
    pure-OR, (a_cb_t,) for bool2 or (a_rq_t, a_sh_t, a_ng_t) for bool;
    ``params_t`` f32 [>=2, Q] rows num_required / min_should.

    Returns (tile_max f32 [Q, D/128], hits i32 [Q]); boolean tile maxima
    are -1 on tiles without a feasible doc. The doc axis runs in chunks
    so each chunk's products stay near ``chunk_bytes``."""
    U8, D = bank.shape
    Q = a_sc_t.shape[1]
    G = D // LANE
    per_tile = (1 + len(roles)) * Q * LANE * 4
    ct = max(1, min(G, chunk_bytes // per_tile))
    nfull, rem = divmod(G, ct)
    w = ct * LANE

    def body(_, i):
        start = i * w
        b = jax.lax.dynamic_slice_in_dim(bank, start, w, axis=1)
        lv = jax.lax.dynamic_slice_in_dim(live, start, w)
        return None, _chunk(b, lv, a_sc_t, roles, params_t)

    if nfull == 1:
        tmaxs, hits = [], []
        t, h = _chunk(bank[:, :w], live[:w], a_sc_t, roles, params_t)
        tmaxs.append(t)
        hits.append(h)
    else:
        _, (t, h) = jax.lax.scan(
            body, None, jnp.arange(nfull, dtype=jnp.int32)
        )
        tmaxs = [t.transpose(1, 0, 2).reshape(Q, nfull * ct)]
        hits = [h.sum(axis=0)]
    if rem:
        t, h = _chunk(
            bank[:, nfull * w:], live[nfull * w:], a_sc_t, roles, params_t
        )
        tmaxs.append(t)
        hits.append(h)
    tmax = tmaxs[0] if len(tmaxs) == 1 else jnp.concatenate(tmaxs, axis=1)
    return tmax, sum(hits[1:], hits[0])


# Programs traced on a GPU run phase 1 as the Pallas kernel. The plain
# form is the reference, the CPU path, and the end-to-end comparison
# chip_smoke.py makes by clearing this (read when a program is traced).
GPU_KERNEL = True


def approx_select(bank, live, a_sc_t, roles=(), params_t=None):
    """Phase 1 on the running backend: the Triton kernel on a GPU, the
    plain XLA form elsewhere (the CPU test tier). Same contract as
    ``approx_select_xla``. On the H100 the kernel also matched the exact
    reference where the plain form's boolean hit counts did not (see
    PERF.md)."""
    if GPU_KERNEL and jax.default_backend() == "gpu":
        from diagon_tpu.ops.pallas.approx_pass import approx_select_triton

        return approx_select_triton(bank, live, a_sc_t, roles, params_t)
    return approx_select_xla(bank, live, a_sc_t, roles, params_t)
