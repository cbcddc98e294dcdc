"""Phase 1 as one Pallas kernel on the Triton route (GPU).

The plain form (``ops/approx.py``) writes every [Q, chunk] f32 product
to device memory and reads it back for the per-tile max and count —
XLA cannot fuse a reduction into the matrix product. This kernel keeps
each product in registers: one program owns ``TPB`` 128-doc tiles x
``BQ`` queries, multiplies each bf16 bank tile [U8, 128] by the bf16
indicator block [U8, BQ] with f32 accumulation (``pl.dot``), reduces
the 128 docs of the tile to their maximum and match count, and writes
only the tile maxima plus a per-program PARTIAL hit count, which XLA
sums afterwards (GPU programs run in parallel in no fixed order, so
nothing carries between them).

Presence (``bank > 0``) and the ``rq*256 + sh`` decode are derived
in-kernel exactly as in the plain form, so the two agree bit for bit on
counts and up to f32 summation order on maxima.

Shapes: Triton tensors have power-of-two dims and ``pl.dot`` wants every
dim >= 16. The row axis runs in steps of ``KB`` rows, so U8 is padded
with zero rows (they add nothing to any product) to ``bank_rows(U8)``,
and Q to a multiple of the query block. Executors build their banks at
``bank_rows`` already, so the row pad is a no-op on the serving path.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from diagon_tpu.ops.approx import KB, LANE, bank_rows


def _pow2(n: int, floor: int) -> int:
    return max(floor, 1 << max(0, n - 1).bit_length())


# queries per program by role count: each role adds a [128, BQ] f32
# accumulator, so BQ shrinks with the roles to keep the accumulators at
# 64 KB of registers per program
BQ = {0: 128, 1: 64, 3: 32}
TPB = 8  # 128-doc tiles per program
NUM_WARPS = 4
NUM_STAGES = 2


def _kernel(*refs, n_roles: int, tpb: int, kb: int):
    bank_ref, live_ref, asc_ref = refs[:3]
    role_refs = refs[3 : 3 + n_roles]
    params_ref, tmax_ref, hits_ref = refs[3 + n_roles :]
    bq = asc_ref.shape[1]
    nk = asc_ref.shape[0] // kb
    nreq = params_ref[0, :]  # [BQ]
    msm = params_ref[1, :]

    def body(t, cnt):
        # the row axis runs in KB-row steps so the bank and indicator
        # slices stay small at any U8
        def kstep(k, accs):
            rows = pl.ds(k * kb, kb)
            b = bank_ref[rows, pl.ds(t * LANE, LANE)]  # [KB, 128] bf16
            out = [accs[0] + pl.dot(b, asc_ref[rows, :], trans_a=True)]
            if n_roles:
                pres = jnp.where(b > 0, 1.0, 0.0).astype(b.dtype)
                out += [
                    a + pl.dot(pres, r[rows, :], trans_a=True)
                    for a, r in zip(accs[1:], role_refs)
                ]
            return tuple(out)

        zero = jnp.zeros((LANE, bq), jnp.float32)
        accs = jax.lax.fori_loop(0, nk, kstep, (zero,) * (1 + n_roles))
        ap = accs[0]  # [128, BQ] f32
        lv = live_ref[pl.ds(t * LANE, LANE)] > 0  # [128]
        if n_roles == 0:
            m = (ap > 0) & lv[:, None]
        elif n_roles == 1:
            cc = accs[1]
            rc = jnp.floor(cc * jnp.float32(1.0 / 256.0))
            oc = cc - rc * jnp.float32(256.0)
            m = (
                (rc == nreq[None, :]) & (oc >= msm[None, :])
                & (cc > 0) & lv[:, None]
            )
        else:
            rc, oc, nc = accs[1:]
            m = (
                (rc == nreq[None, :]) & (oc >= msm[None, :])
                & (nc == 0) & ((rc + oc) > 0) & lv[:, None]
            )
        c = jnp.sum(m.astype(jnp.int32), axis=0)  # [BQ]
        mx = jnp.max(ap, axis=0)
        if n_roles:
            mx = jnp.where(c > 0, mx, jnp.float32(-1.0))
        tmax_ref[pl.ds(t, 1), :] = mx[None, :]
        return cnt + c

    cnt = jax.lax.fori_loop(0, tpb, body, jnp.zeros((bq,), jnp.int32))
    hits_ref[...] = cnt[None, :]


@functools.partial(jax.jit, static_argnames=("interpret",))
def approx_select_triton(bank, live, a_sc_t, roles=(), params_t=None, *,
                         interpret: bool = False):
    """Same contract as ``ops.approx.approx_select_xla``: returns
    (tile_max f32 [Q, D/128], hits i32 [Q]). ``interpret`` runs the
    kernel in the Pallas interpreter (CPU tests)."""
    U8, D = bank.shape
    Q = a_sc_t.shape[1]
    G = D // LANE
    n_roles = len(roles)
    u8p = bank_rows(U8)
    bq = min(BQ[n_roles], _pow2(Q, 16))
    tpb = TPB
    while G % tpb:
        tpb //= 2
    qp = -(-Q // bq) * bq
    if params_t is None:
        params_t = jnp.zeros((2, Q), jnp.float32)

    def pad(a, rows):
        return jnp.pad(a, ((0, rows - a.shape[0]), (0, qp - a.shape[1])))

    if u8p != U8:
        bank = jnp.pad(bank, ((0, u8p - U8), (0, 0)))
    ins = [pad(a, u8p) for a in (a_sc_t, *roles)]
    params = pad(params_t[:2].astype(jnp.float32), 2)
    nq, nc = qp // bq, G // tpb
    amap = lambda qb, c: (0, qb)
    tmax_t, hits = pl.pallas_call(
        functools.partial(
            _kernel, n_roles=n_roles, tpb=tpb, kb=min(u8p, KB)
        ),
        grid=(nq, nc),
        in_specs=[
            pl.BlockSpec((u8p, tpb * LANE), lambda qb, c: (0, c)),
            pl.BlockSpec((tpb * LANE,), lambda qb, c: (c,)),
            *[pl.BlockSpec((u8p, bq), amap) for _ in ins],
            pl.BlockSpec((2, bq), amap),
        ],
        out_specs=(
            pl.BlockSpec((tpb, bq), lambda qb, c: (c, qb)),
            pl.BlockSpec((1, bq), lambda qb, c: (c, qb)),
        ),
        out_shape=(
            jax.ShapeDtypeStruct((G, qp), jnp.float32),
            jax.ShapeDtypeStruct((nc, qp), jnp.int32),
        ),
        backend="triton",
        compiler_params=plt.CompilerParams(
            num_warps=NUM_WARPS, num_stages=NUM_STAGES
        ),
        interpret=interpret,
        name=f"approx_select_r{n_roles}",
    )(bank, live, *ins, params)
    return tmax_t[:, :Q].T, hits.sum(axis=0)[:Q]
