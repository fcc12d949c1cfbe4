"""Unrolled evaluator tests: static-index evaluation matches the compiled
(gather/scatter) system, alone and inside batched LM solves."""

import numpy as np
import jax
import jax.numpy as jnp

import ezpz_jax  # noqa: F401
from ezpz_jax.config import Config
from ezpz_jax.constraints import Constraint
from ezpz_jax.datatypes import DatumCircle, DatumDistance, DatumLineSegment, DatumPoint
from ezpz_jax.models.compiled import compile_system
from ezpz_jax.ops.unrolled import UnrolledSystem
from ezpz_jax.solver import solve_lm


def _mixed_system(dtype=jnp.float64):
    # Well-constrained on purpose: an underconstrained direction would make
    # bit-level arithmetic differences (gather vs unrolled evaluation in
    # f32) land on different points of the solution manifold.
    p0, p1 = DatumPoint(0, 1), DatumPoint(2, 3)
    circle = DatumCircle(center=DatumPoint(4, 5), radius=DatumDistance(6))
    cs = [
        Constraint.Fixed(p0.x_id, 0.25),
        Constraint.Fixed(p0.y_id, 0.1),
        Constraint.Distance(p0, p1, 3.0),
        Constraint.Vertical(DatumLineSegment(p0, p1)),
        Constraint.CircleRadius(circle, 1.5),
        Constraint.PointsCoincident(p1, circle.center),
    ]
    weights = [1.0, 1.0, 2.0, 1.0, 1.0, 0.5]
    return compile_system(cs, n_vars=7, weights=weights, dtype=dtype)


def test_unrolled_matches_compiled():
    system = _mixed_system()
    un = UnrolledSystem(system)
    x = jnp.asarray(np.linspace(0.1, 1.9, 7))

    r_c, deg_c = system.residual_and_flags(x)
    r_u, deg_u = un.residual_and_flags(x)
    np.testing.assert_allclose(np.asarray(r_u), np.asarray(r_c), rtol=1e-14)
    np.testing.assert_array_equal(np.asarray(deg_u), np.asarray(deg_c))

    r_c, jtj_c, jtr_c, _ = system.normal_equations(x)
    r_u, jtj_u, jtr_u, _ = un.normal_equations(x)
    np.testing.assert_allclose(np.asarray(r_u), np.asarray(r_c), rtol=1e-14)
    np.testing.assert_allclose(np.asarray(jtj_u), np.asarray(jtj_c), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(np.asarray(jtr_u), np.asarray(jtr_c), rtol=1e-12, atol=1e-14)

    J_c = system.jacobian_dense(x)
    J_u = un.jacobian_dense(x)
    np.testing.assert_allclose(np.asarray(J_u), np.asarray(J_c), rtol=1e-12, atol=1e-14)


def test_unrolled_solve_matches_compiled_solve():
    system = _mixed_system()
    un = UnrolledSystem(system)
    x0 = jnp.asarray(np.array([0.3, 0.1, 0.2, 3.3, 0.25, 3.2, 1.1]))
    cfg = Config()
    a = solve_lm(system, x0, cfg.max_iterations, cfg.residual_tolerance,
                 cfg.step_tolerance, cfg.initial_lambda)
    b = solve_lm(un, x0, cfg.max_iterations, cfg.residual_tolerance,
                 cfg.step_tolerance, cfg.initial_lambda)
    assert bool(a.converged) and bool(b.converged)
    assert int(a.iterations) == int(b.iterations)
    np.testing.assert_allclose(np.asarray(b.x), np.asarray(a.x), atol=1e-12)


def test_batched_lanes_freeze_on_convergence():
    """Regression: under vmap the while_loop runs until the SLOWEST lane
    finishes; already-converged lanes must freeze — identical x and
    iteration counts to solo solves — not keep stepping (which would drift
    underconstrained solutions)."""
    from ezpz_jax.batch import BatchSolver

    # Underconstrained: nothing pins p0.y/p1.y absolutely.
    p0, p1 = DatumPoint(0, 1), DatumPoint(2, 3)
    cs = [
        Constraint.Fixed(p0.x_id, 0.25),
        Constraint.Distance(p0, p1, 3.0),
        Constraint.Vertical(DatumLineSegment(p0, p1)),
    ]
    system = compile_system(cs, n_vars=4)
    cfg = Config()

    # Lane 0 starts at the solution (0 iterations); lane 1 starts far away.
    x0s = np.array([
        [0.25, 1.0, 0.25, 4.0],
        [0.9, 0.4, -1.2, 2.7],
    ])
    batch = BatchSolver(system, cfg).solve(jnp.asarray(x0s))
    for lane in range(2):
        solo = solve_lm(system, jnp.asarray(x0s[lane]), cfg.max_iterations,
                        cfg.residual_tolerance, cfg.step_tolerance,
                        cfg.initial_lambda)
        assert int(np.asarray(batch.iterations)[lane]) == int(solo.iterations), lane
        np.testing.assert_allclose(np.asarray(batch.x)[lane],
                                   np.asarray(solo.x), atol=1e-12)
    assert int(np.asarray(batch.iterations)[0]) == 0
