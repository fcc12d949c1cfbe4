"""Medium tier of ``ops/linalg.py`` (24 < n): parity against numpy/XLA
factorizations, failure semantics, dtypes, batching — for BOTH the default
XLA-cholesky routing of ``spd_solve`` and the opt-in hand-blocked kernel
(``_blocked_spd_solve``; kept parity-tested although the default routes
to XLA).

This tier replaces the reference's sparse LLT for medium coupled systems
(``ezpz/src/solver/newton.rs:87-102``): dense matmul work instead of sparse
scalar bookkeeping.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import ezpz_jax  # noqa: F401  (x64 on)
from ezpz_jax.ops.linalg import (
    BLOCK_NB,
    UNROLL_MAX_N,
    _blocked_spd_solve,
    _chol_blocked,
    spd_solve,
    spd_solve_multi,
)


def _spd(rng, n, dtype=np.float64):
    m = rng.standard_normal((n, n))
    return np.asarray(m @ m.T + n * np.eye(n), dtype=dtype)


@pytest.mark.parametrize("n", [25, 31, 32, 33, 64, 100, 257, 512])
def test_blocked_solve_matches_numpy(n):
    rng = np.random.default_rng(n)
    A = _spd(rng, n)
    b = rng.standard_normal(n)
    x, fail = jax.jit(spd_solve)(jnp.asarray(A), jnp.asarray(b))
    assert not bool(fail)
    ref = np.linalg.solve(A, b)
    np.testing.assert_allclose(np.asarray(x), ref, rtol=0, atol=1e-10 * n)


def test_blocked_factor_matches_xla_cholesky():
    """The factor itself (not just the solve) agrees with XLA's cholesky —
    a parity check on the factor, not only on the solve."""
    rng = np.random.default_rng(7)
    n = 96  # multiple of BLOCK_NB: no padding in the comparison
    assert n % BLOCK_NB == 0
    A = jnp.asarray(_spd(rng, n))
    L, _inv = jax.jit(lambda a: _chol_blocked(a, BLOCK_NB))(A)
    ref = jnp.linalg.cholesky(A)
    np.testing.assert_allclose(np.asarray(L), np.asarray(ref), atol=1e-9)


@pytest.mark.parametrize("n", [40, 100, 257])
def test_blocked_kernel_matches_default_routing(n):
    """The opt-in blocked kernel solves to the same answer as the default
    XLA tier (padding tail included)."""
    rng = np.random.default_rng(n + 1)
    A = jnp.asarray(_spd(rng, n))
    b = jnp.asarray(rng.standard_normal(n))
    x_blk, f_blk = jax.jit(_blocked_spd_solve)(A, b)
    x_def, f_def = jax.jit(spd_solve)(A, b)
    assert not bool(f_blk) and not bool(f_def)
    np.testing.assert_allclose(np.asarray(x_blk), np.asarray(x_def), atol=1e-9)


def test_blocked_multi_rhs():
    rng = np.random.default_rng(3)
    n, m = 100, 9
    A = _spd(rng, n)
    B = rng.standard_normal((n, m))
    X, fail = jax.jit(spd_solve_multi)(jnp.asarray(A), jnp.asarray(B))
    assert not bool(fail)
    np.testing.assert_allclose(np.asarray(X), np.linalg.solve(A, B), atol=1e-8)


def test_blocked_non_spd_fails_cleanly():
    """Non-SPD input: fail=True, x zero-filled, no NaN leaks (the LM loop
    treats this as a rejected step, newton.rs:96-99)."""
    n = 40
    A = jnp.asarray(-np.eye(n))
    x, fail = jax.jit(spd_solve)(A, jnp.ones(n))
    assert bool(fail)
    assert bool(jnp.all(x == 0.0))
    assert bool(jnp.all(jnp.isfinite(x)))


def test_blocked_f32():
    rng = np.random.default_rng(11)
    n = 200
    A = _spd(rng, n, np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    x, fail = jax.jit(spd_solve)(jnp.asarray(A), jnp.asarray(b))
    assert x.dtype == jnp.float32
    assert not bool(fail)
    ref = np.linalg.solve(A.astype(np.float64), b.astype(np.float64))
    rel = np.max(np.abs(np.asarray(x) - ref)) / max(1.0, np.max(np.abs(ref)))
    assert rel < 1e-4


def test_blocked_vmap_batching():
    """The blocked tier must vmap (BatchSolver runs it per sketch)."""
    rng = np.random.default_rng(5)
    n, B = 48, 6
    As = np.stack([_spd(rng, n) for _ in range(B)])
    bs = rng.standard_normal((B, n))
    xs, fails = jax.jit(jax.vmap(spd_solve))(jnp.asarray(As), jnp.asarray(bs))
    assert not bool(fails.any())
    for i in range(B):
        np.testing.assert_allclose(
            np.asarray(xs[i]), np.linalg.solve(As[i], bs[i]), atol=1e-9
        )


def test_blocked_mixed_batch_one_failure():
    """One non-SPD lane in a vmapped batch fails alone; the healthy lanes
    still solve (per-lane fail flags, no cross-lane contamination)."""
    rng = np.random.default_rng(9)
    n, B = 40, 3
    As = np.stack([_spd(rng, n) for _ in range(B)])
    As[1] = -np.eye(n)
    bs = rng.standard_normal((B, n))
    xs, fails = jax.jit(jax.vmap(spd_solve))(jnp.asarray(As), jnp.asarray(bs))
    assert list(np.asarray(fails)) == [False, True, False]
    np.testing.assert_allclose(np.asarray(xs[0]), np.linalg.solve(As[0], bs[0]), atol=1e-9)
    assert bool(jnp.all(xs[1] == 0.0))
    np.testing.assert_allclose(np.asarray(xs[2]), np.linalg.solve(As[2], bs[2]), atol=1e-9)


@pytest.mark.parametrize("n", [25, 48, 64])
def test_batched_colunroll_tier_matches_numpy(n):
    """spd_solve_batched's mid-size tier (column-unrolled, for vmapped
    contexts): parity, batching, and failure semantics."""
    from ezpz_jax.ops.linalg import spd_solve_batched, spd_solve_multi_batched

    rng = np.random.default_rng(n)
    B = 5
    As = np.stack([_spd(rng, n) for _ in range(B)])
    bs = rng.standard_normal((B, n))
    xs, fails = jax.jit(jax.vmap(spd_solve_batched))(jnp.asarray(As), jnp.asarray(bs))
    assert not bool(np.asarray(fails).any())
    for i in range(B):
        np.testing.assert_allclose(np.asarray(xs[i]),
                                   np.linalg.solve(As[i], bs[i]), atol=1e-8)
    # multi-RHS
    Bs = rng.standard_normal((B, n, 3))
    Xs, f2 = jax.jit(jax.vmap(spd_solve_multi_batched))(jnp.asarray(As), jnp.asarray(Bs))
    assert not bool(np.asarray(f2).any())
    np.testing.assert_allclose(np.asarray(Xs[0]),
                               np.linalg.solve(As[0], Bs[0]), atol=1e-8)
    # non-SPD lane fails alone, zero-filled and finite
    As[2] = -np.eye(n)
    xs, fails = jax.jit(jax.vmap(spd_solve_batched))(jnp.asarray(As), jnp.asarray(bs))
    assert bool(np.asarray(fails)[2]) and not bool(np.asarray(fails)[0])
    assert bool(jnp.all(xs[2] == 0.0)) and bool(jnp.all(jnp.isfinite(xs[2])))


def test_unrolled_tier_unchanged():
    """The n <= UNROLL_MAX_N boundary still routes to the unrolled path
    (same results either way; this pins the routing constant)."""
    assert UNROLL_MAX_N == 24
    rng = np.random.default_rng(2)
    A = _spd(rng, UNROLL_MAX_N)
    b = rng.standard_normal(UNROLL_MAX_N)
    x, fail = jax.jit(spd_solve)(jnp.asarray(A), jnp.asarray(b))
    assert not bool(fail)
    np.testing.assert_allclose(np.asarray(x), np.linalg.solve(A, b), atol=1e-9)


def test_blocked_inside_while_loop():
    """spd_solve at blocked sizes must trace inside lax.while_loop (the LM
    loop) — dynamic slicing and fori nesting included."""
    rng = np.random.default_rng(13)
    n = 30
    A = jnp.asarray(_spd(rng, n))
    b = jnp.asarray(rng.standard_normal(n))

    def cond(s):
        it, _x = s
        return it < 3

    def body(s):
        it, x = s
        d, _fail = spd_solve(A + it * 0.1 * jnp.eye(n), b - x)
        return it + 1, x + 0.5 * d

    _it, x = jax.jit(lambda: jax.lax.while_loop(cond, body, (0, jnp.zeros(n))))()
    assert bool(jnp.all(jnp.isfinite(x)))
