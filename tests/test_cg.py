"""Matrix-free LM-CG solver tests: must match the dense-Cholesky LM solution
on well-conditioned systems without ever materializing JtJ."""

import numpy as np

import jax.numpy as jnp

from ezpz_jax.constraints import Constraint
from ezpz_jax.datatypes import DatumLineSegment, DatumPoint
from ezpz_jax.models.compiled import compile_system
from ezpz_jax.solver import solve_lm, solve_lm_cg


def _chain_system(n_pts=40):
    """A long chain: fixed start, unit distances, horizontal segments."""
    cs = []
    pts = [DatumPoint(2 * i, 2 * i + 1) for i in range(n_pts)]
    cs.append(Constraint.Fixed(pts[0].x_id, 0.0))
    cs.append(Constraint.Fixed(pts[0].y_id, 0.0))
    for i in range(n_pts - 1):
        cs.append(Constraint.Distance(pts[i], pts[i + 1], 1.0))
        cs.append(Constraint.Horizontal(DatumLineSegment(pts[i], pts[i + 1])))
    rng = np.random.default_rng(5)
    x0 = np.zeros(2 * n_pts)
    x0[0::2] = np.arange(n_pts) * 1.05 + rng.uniform(-0.05, 0.05, n_pts)
    x0[1::2] = rng.uniform(-0.2, 0.2, n_pts)
    return cs, x0


def test_lm_cg_matches_dense():
    cs, x0 = _chain_system()
    system = compile_system(cs, len(x0))
    dense = solve_lm(system, jnp.asarray(x0), 35, 1e-8, 1e-12, 1e-9)
    cg = solve_lm_cg(system, jnp.asarray(x0), 35, 1e-8, 1e-12, 1e-9)
    assert bool(dense.converged) and bool(cg.converged)
    np.testing.assert_allclose(np.asarray(cg.x), np.asarray(dense.x), atol=1e-7)
    # Both converge to the same residual level.
    assert float(jnp.max(jnp.abs(cg.residual))) <= 1e-8


def test_jtj_matvec_matches_dense_jtj():
    cs, x0 = _chain_system(10)
    system = compile_system(cs, len(x0))
    x = jnp.asarray(x0)
    _r, jtj, _jtr, _d = system.normal_equations(x)
    _r2, _jtr2, wjacs, _d2 = system.jacobian_factors(x)
    rng = np.random.default_rng(0)
    for _ in range(3):
        v = jnp.asarray(rng.normal(size=len(x0)))
        np.testing.assert_allclose(
            np.asarray(system.jtj_matvec(wjacs, v)),
            np.asarray(jtj @ v),
            atol=1e-10,
        )


def test_cg_warm_start_contract():
    """_cg must honour a nonzero initial guess (r0 = b - A x0): started AT
    the solution it stays there; started nearby it still converges to the
    same point. (The LM caller always passes zeros, so only a direct unit
    test can see the initial-residual sign — mutation-found.)"""
    from ezpz_jax.solver import _cg

    rng = np.random.default_rng(3)
    M = rng.standard_normal((4, 4))
    A = M @ M.T + 4 * np.eye(4)
    b = rng.standard_normal(4)
    xstar = np.linalg.solve(A, b)
    mv = lambda v: jnp.asarray(A) @ v
    at_solution = _cg(mv, jnp.asarray(b), jnp.asarray(xstar), 1e-13, 50)
    np.testing.assert_allclose(np.asarray(at_solution), xstar, atol=1e-10)
    near = _cg(mv, jnp.asarray(b), jnp.asarray(xstar + 0.1), 1e-13, 50)
    np.testing.assert_allclose(np.asarray(near), xstar, atol=1e-8)
    # The documented default inner tolerance and iteration budget (f64 path).
    import inspect
    params = inspect.signature(solve_lm_cg).parameters
    assert params["cg_tol"].default == 1e-12
    assert params["cg_max_iters"].default == 400


def test_cg_krylov_efficiency():
    """Exact CG on an SPD n x n system converges within ~n iterations.
    Run with a budget of n+2: only the true conjugate direction update
    p = r + (rs_new/rs) p gets there — a corrupted recurrence (e.g. a
    sign flip, mutation-found) loses conjugacy and stalls far from the
    solution inside the same budget."""
    from ezpz_jax.solver import _cg

    rng = np.random.default_rng(5)
    M = rng.standard_normal((16, 16))
    A = M @ M.T + 0.5 * np.eye(16)
    b = rng.standard_normal(16)
    xstar = np.linalg.solve(A, b)
    mv = lambda v: jnp.asarray(A) @ v
    x = _cg(mv, jnp.asarray(b), jnp.zeros(16), 1e-12, 18)
    np.testing.assert_allclose(np.asarray(x), xstar, atol=1e-8)


def test_cg_budget_contract():
    """The CG iteration budget is strict and the counter increments:
    max_iters=0 returns the initial guess untouched, and a 2-iteration
    budget on a 16x16 system must NOT reach the solution (a corrupted
    counter, e.g. it-1, would loop to full convergence; an inclusive
    bound would run one extra step). Mutation-found."""
    from ezpz_jax.solver import _cg

    rng = np.random.default_rng(5)
    M = rng.standard_normal((16, 16))
    A = M @ M.T + 0.5 * np.eye(16)
    b = rng.standard_normal(16)
    xstar = np.linalg.solve(A, b)
    mv = lambda v: jnp.asarray(A) @ v
    z = _cg(mv, jnp.asarray(b), jnp.zeros(16), 1e-30, 0)
    assert bool(jnp.all(z == 0.0))
    two = _cg(mv, jnp.asarray(b), jnp.zeros(16), 1e-30, 2)
    assert float(np.max(np.abs(np.asarray(two) - xstar))) > 1e-3


def test_cg_damping_sign_matches_dense_at_high_lambda():
    """The matrix-free operator is JtJ + lam*I. At initial_lambda = 100
    the damping dominates, so solve_lm_cg must reproduce the dense path's
    trajectory (same iterations, same solution); a flipped damping sign
    makes the inner operator indefinite and the first heavily-damped step
    point the wrong way. Mutation-found (at the default lam = 1e-9 the
    sign is numerically invisible)."""
    from ezpz_jax.solver import solve_lm_cg

    p, q = DatumPoint(0, 1), DatumPoint(2, 3)
    cs = [Constraint.Fixed(0, 0.0), Constraint.Fixed(1, 0.0),
          Constraint.Fixed(2, 3.0), Constraint.Distance(p, q, 5.0)]
    system = compile_system(cs, n_vars=4)
    x0 = jnp.asarray(np.array([0.1, -0.1, 3.2, 3.6]))
    cg = solve_lm_cg(system, x0, 35, 1e-8, 1e-12, 100.0)
    dense = solve_lm(system, x0, 35, 1e-8, 1e-12, 100.0)
    assert bool(cg.converged) and bool(dense.converged)
    np.testing.assert_allclose(np.asarray(cg.x), np.asarray(dense.x),
                               atol=1e-9)
    assert int(cg.iterations) == int(dense.iterations)
