"""Phase 1 (approximate scores -> tile maxima + exact hit counts).

The plain XLA form (``ops.approx.approx_select_xla``) is checked against
a float64 numpy reference, and the GPU kernel
(``ops.pallas.approx_pass.approx_select_triton``) against the plain form
in the Pallas interpreter: OR, bool2 and bool variants, U8 padding, a Q
that is not a multiple of the query block, and doc counts that do not
divide the chunk or the per-program tile block.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from diagon_tpu.ops.approx import approx_select_xla  # noqa: E402
from diagon_tpu.ops.pallas.approx_pass import (  # noqa: E402
    approx_select_triton,
)
from diagon_tpu.search.row_engine import _APPROX_RELEPS  # noqa: E402

LANE = 128


def _inputs(mode, U8, Q, G, seed):
    rng = np.random.Generator(np.random.PCG64(seed))
    D = G * LANE
    bank = (rng.random((U8, D)) * 9).astype(np.float32)
    bank[rng.random((U8, D)) < 0.7] = 0.0
    bank[0] = 0.0  # the zero row
    live = (rng.random(D) < 0.95).astype(np.float32)

    def ind(p):
        a = (rng.random((U8, Q)) < p).astype(np.float32)
        a[0] = 0.0
        return a

    a_sc = ind(0.2)
    rq, sh, ng = ind(0.06), ind(0.1), ind(0.03)
    if mode == "bool2":
        sh[rq > 0] = 0.0  # no row serves both roles for one query
        ng[:] = 0.0
    params = np.zeros((8, Q), np.float32)
    params[0] = rq.sum(axis=0)
    params[1] = np.minimum(1, sh.sum(axis=0))
    roles = {
        "or": (),
        "bool2": (rq * 256 + sh,),
        "bool": (rq, sh, ng),
    }[mode]
    return bank, live, a_sc, roles, params


def _bf(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


def _reference(bank, live, a_sc, roles, params):
    """float64 numpy phase 1 over the bf16-rounded bank."""
    b16 = np.asarray(_bf(bank).astype(jnp.float32), np.float64)
    U8, D = bank.shape
    G = D // LANE
    ap = (a_sc.T.astype(np.float64) @ b16).reshape(-1, G, LANE)
    lv = (live > 0).reshape(1, G, LANE)
    if not roles:
        m = (ap > 0) & lv
        return ap.max(axis=2), m.sum(axis=(1, 2))
    pres = (bank > 0).astype(np.float64)
    cnt = [(r.T.astype(np.float64) @ pres).reshape(-1, G, LANE)
           for r in roles]
    nreq = params[0][:, None, None]
    msm = params[1][:, None, None]
    if len(roles) == 1:
        rc, oc = np.divmod(cnt[0], 256)
        m = (rc == nreq) & (oc >= msm) & (cnt[0] > 0) & lv
    else:
        rc, oc, nc = cnt
        m = (rc == nreq) & (oc >= msm) & (nc == 0) & ((rc + oc) > 0) & lv
    tile_cnt = m.sum(axis=2)
    tmax = np.where(tile_cnt > 0, ap.max(axis=2), -1.0)
    return tmax, tile_cnt.sum(axis=1)


@pytest.mark.parametrize("mode", ["or", "bool2", "bool"])
@pytest.mark.parametrize("chunk_tiles", [3, 1000])
def test_xla_phase1_matches_numpy(mode, chunk_tiles):
    """Exact hit counts and tile maxima within f32 summation order of the
    float64 reference, both unchunked and with a chunk size that leaves a
    remainder (G=20 tiles in chunks of 3)."""
    Q, G = 24, 20
    bank, live, a_sc, roles, params = _inputs(mode, 24, Q, G, seed=4)
    per_tile = (1 + len(roles)) * Q * LANE * 4
    tmax, hits = approx_select_xla(
        _bf(bank), jnp.asarray(live), _bf(a_sc),
        tuple(_bf(r) for r in roles), jnp.asarray(params),
        chunk_bytes=chunk_tiles * per_tile,
    )
    want_t, want_h = _reference(bank, live, a_sc, roles, params)
    np.testing.assert_array_equal(np.asarray(hits), want_h)
    np.testing.assert_allclose(np.asarray(tmax), want_t, rtol=2.0 ** -16)


@pytest.mark.parametrize(
    "mode,U8,Q,G",
    [
        ("or", 24, 40, 24),  # U8 pads 24 -> 32, Q ragged vs its block
        ("bool2", 24, 40, 24),
        ("bool", 24, 40, 24),
        ("or", 16, 130, 12),  # tile block halves (12 % 8), Q > 128
        ("bool2", 100, 17, 16),  # U8 pads 100 -> 128: two row steps
        ("bool", 16, 16, 8),
        ("or", 130, 24, 16),  # U8 pads 130 -> 192: three row steps
        ("bool", 130, 20, 8),
    ],
)
def test_triton_phase1_matches_xla(mode, U8, Q, G):
    """The GPU kernel (Pallas interpreter) against the plain form: hit
    counts exactly equal, tile maxima within 2^-8 relative (f32
    summation order; bf16 operands are identical), infeasible -1
    markers identical."""
    bank, live, a_sc, roles, params = _inputs(mode, U8, Q, G, seed=U8 + Q)
    args = (
        _bf(bank), jnp.asarray(live), _bf(a_sc),
        tuple(_bf(r) for r in roles), jnp.asarray(params),
    )
    tx, hx = approx_select_xla(*args)
    tt, ht = approx_select_triton(*args, interpret=True)
    assert tt.shape == (Q, G) and ht.shape == (Q,)
    np.testing.assert_array_equal(np.asarray(ht), np.asarray(hx))
    tx, tt = np.asarray(tx), np.asarray(tt)
    np.testing.assert_array_equal(tt < 0, tx < 0)
    np.testing.assert_allclose(tt, tx, rtol=2.0 ** -8)


def test_triton_phase1_upper_bound_sound():
    """Soundness of the selection bound on the kernel's output: every
    tile's exact f32 maximum (f32 contributions summed in clause order)
    is <= tmax * (1 + 2^-7)."""
    bank, live, a_sc, roles, params = _inputs("or", 32, 32, 16, seed=7)
    tmax, _ = approx_select_triton(
        _bf(bank), jnp.asarray(live), _bf(a_sc), (), None, interpret=True
    )
    exact = np.zeros((32, bank.shape[1]), np.float32)
    for r in range(bank.shape[0]):
        exact = (exact + a_sc[r][:, None] * bank[r][None, :]).astype(
            np.float32
        )
    ex_t = exact.reshape(32, 16, LANE).max(axis=2)
    upper = np.asarray(tmax) * (np.float32(1.0) + _APPROX_RELEPS)
    assert (ex_t <= upper).all()
