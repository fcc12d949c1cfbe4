"""Mixed-precision (f32 LM + f64-residual refinement) solver tests.

The mixed path runs the LM loop in f32 and only residual evaluations in f64
(inexact Newton / iterative refinement). These tests pin its contract:
the final f64 inf-norm residual meets the same 1e-8 tolerance as the pure
f64 path, and final coordinates agree with the f64 path within 1e-6.
"""

import numpy as np
import jax.numpy as jnp
import pytest

import ezpz_jax  # noqa: F401  (x64 on)
from ezpz_jax.batch import BatchSolver
from ezpz_jax.config import Config
from ezpz_jax.constraints import Constraint
from ezpz_jax.datatypes import DatumCircle, DatumDistance, DatumLineSegment, DatumPoint
from ezpz_jax.models.compiled import compile_system
from ezpz_jax.solver import solve_lm, solve_lm_mixed
from ezpz_jax.textual import Problem


def _mixed_solve(constraints, x0, **kw):
    system64 = compile_system(constraints, n_vars=len(x0))
    system32 = system64.astype(jnp.float32)
    cfg = Config()
    return solve_lm_mixed(
        system64, system32, jnp.asarray(np.asarray(x0, dtype=np.float64)),
        cfg.max_iterations, cfg.residual_tolerance, cfg.step_tolerance,
        cfg.initial_lambda, **kw,
    )


def _f64_solve(constraints, x0):
    system = compile_system(constraints, n_vars=len(x0))
    cfg = Config()
    return solve_lm(
        system, jnp.asarray(np.asarray(x0, dtype=np.float64)),
        cfg.max_iterations, cfg.residual_tolerance, cfg.step_tolerance,
        cfg.initial_lambda,
    )


def _square_system():
    p0, p1, p2, p3 = (DatumPoint(2 * i, 2 * i + 1) for i in range(4))
    lines = [
        DatumLineSegment(p0, p1), DatumLineSegment(p1, p2),
        DatumLineSegment(p2, p3), DatumLineSegment(p3, p0),
    ]
    constraints = [
        Constraint.Fixed(p0.x_id, 0.0),
        Constraint.Fixed(p0.y_id, 0.0),
        Constraint.Horizontal(lines[0]),
        Constraint.Vertical(lines[1]),
        Constraint.Horizontal(lines[2]),
        Constraint.Vertical(lines[3]),
        Constraint.Distance(p0, p1, 4.0),
        Constraint.Distance(p1, p2, 4.0),
    ]
    x0 = np.array([0.1, -0.1, 4.3, 0.2, 4.1, 3.8, 0.2, 4.2])
    return constraints, x0


def test_mixed_square_hits_f64_tolerance():
    constraints, x0 = _square_system()
    res = _mixed_solve(constraints, x0)
    assert bool(res.converged)
    assert float(jnp.max(jnp.abs(res.residual))) <= 1e-8
    ref = _f64_solve(constraints, x0)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x), atol=1e-6)


def test_mixed_nonlinear_circle_tangency():
    # Nonlinear constraints: distance + circle radius + tangency.
    p0, p1 = DatumPoint(0, 1), DatumPoint(2, 3)
    circle = DatumCircle(center=DatumPoint(4, 5), radius=DatumDistance(6))
    constraints = [
        Constraint.Fixed(p0.x_id, 0.0),
        Constraint.Fixed(p0.y_id, 0.0),
        Constraint.Distance(p0, p1, 5.0),
        Constraint.Horizontal(DatumLineSegment(p0, p1)),
        Constraint.CircleRadius(circle, 2.0),
        Constraint.PointsCoincident(p0, circle.center),
    ]
    x0 = np.array([0.2, -0.3, 5.4, 0.7, 0.4, 0.1, 1.5])
    res = _mixed_solve(constraints, x0)
    assert bool(res.converged)
    assert float(jnp.max(jnp.abs(res.residual))) <= 1e-8
    ref = _f64_solve(constraints, x0)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x), atol=1e-6)


def test_mixed_batch_matches_f64_batch():
    constraints, x0 = _square_system()
    system = compile_system(constraints, n_vars=len(x0))
    B = 16
    rng = np.random.default_rng(0)
    x0b = jnp.asarray(np.tile(x0, (B, 1)) + rng.normal(0, 0.05, (B, len(x0))))

    ref = BatchSolver(system, Config()).solve(x0b)
    mix = BatchSolver(system, Config(), precision="mixed").solve(x0b)
    assert bool(np.asarray(mix.converged).all())
    assert bool(np.asarray(mix.satisfied).all())
    np.testing.assert_allclose(np.asarray(mix.x), np.asarray(ref.x), atol=1e-6)


def test_mixed_batch_params_massive_fixture():
    """The headline-bench configuration: bucketed massive fixture with
    batched per-component parameters, mixed precision."""
    import os

    from ezpz_jax.models.blocks import build_buckets

    here = os.path.dirname(os.path.abspath(__file__))
    txt = open(os.path.join(here, "cases", "massive_parallel_system", "problem.md")).read()
    cs = Problem.from_str(txt).to_constraint_system()
    constraints = [r.constraint for r in cs.constraints]
    x0 = np.zeros(len(cs.initial_guesses))
    for vid, val in cs.initial_guesses:
        x0[vid] = val

    buckets = build_buckets(constraints, len(x0))
    assert buckets
    M = 4
    for bucket in buckets:
        solver = BatchSolver(bucket.system, Config(), batch_params=True,
                             precision="mixed")
        x0b = jnp.asarray(np.tile(x0[bucket.var_index], (M, 1)))
        pars = tuple(jnp.asarray(np.tile(p, (M, 1, 1))) for p in bucket.pars)
        out = solver.solve(x0b, pars)
        assert bool(np.asarray(out.converged).all())
        assert bool(np.asarray(out.satisfied).all())

        ref = BatchSolver(bucket.system, Config(), batch_params=True).solve(x0b, pars)
        np.testing.assert_allclose(np.asarray(out.x), np.asarray(ref.x), atol=1e-6)


def test_mixed_large_coordinates():
    """Coordinates ~5000: an absolute 5e-6 inf-norm is below f32 round-off,
    so the coarse phase cannot reach it — the capped phase-1 plus the f64
    refinement must still deliver 1e-8."""
    constraints, x0 = _square_system()
    # Translate the square: fix p0 at (5000, 5000) instead of the origin.
    constraints[0] = Constraint.Fixed(0, 5000.0)
    constraints[1] = Constraint.Fixed(1, 5000.0)
    x0 = x0 + 5000.0
    res = _mixed_solve(constraints, x0)
    assert bool(res.converged)
    assert float(jnp.max(jnp.abs(res.residual))) <= 1e-8
    ref = _f64_solve(constraints, x0)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x), atol=1e-5)
    # The coarse tolerance scales with |x0|_inf: the f32 phase converges in
    # a handful of iterations instead of burning its whole 20-iteration cap
    # chasing an absolute 5e-6 below f32 round-off at this scale.
    origin = _square_system()
    baseline = _mixed_solve(*origin)
    assert int(res.iterations) <= int(baseline.iterations) + 4


def test_mixed_1e6_scale_matches_origin_behavior():
    """Coordinate scale 1e6: f32 absolute round-off is
    ~0.06 here, four orders above the old absolute 5e-6 coarse target. The
    scale-aware coarse tolerance keeps phase 1 productive and the f64
    refinement still lands the ABSOLUTE 1e-8 residual; iteration counts
    stay comparable to the O(1) sketch."""
    constraints, x0 = _square_system()
    constraints[0] = Constraint.Fixed(0, 1.0e6)
    constraints[1] = Constraint.Fixed(1, 1.0e6)
    x0 = x0 + 1.0e6
    res = _mixed_solve(constraints, x0)
    assert bool(res.converged)
    assert float(jnp.max(jnp.abs(res.residual))) <= 1e-8
    ref = _f64_solve(constraints, x0)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x), atol=1e-4)
    origin = _square_system()
    baseline = _mixed_solve(*origin)
    assert int(res.iterations) <= int(baseline.iterations) + 4


def test_multi_topology_solver_matches_per_bucket():
    """MultiTopologySolver (all buckets in one jitted call) must agree with
    per-bucket BatchSolver dispatches."""
    import os

    from ezpz_jax.batch import MultiTopologySolver
    from ezpz_jax.models.blocks import build_buckets

    here = os.path.dirname(os.path.abspath(__file__))
    txt = open(os.path.join(here, "cases", "massive_parallel_system", "problem.md")).read()
    cs = Problem.from_str(txt).to_constraint_system()
    constraints = [r.constraint for r in cs.constraints]
    x0 = np.zeros(len(cs.initial_guesses))
    for vid, val in cs.initial_guesses:
        x0[vid] = val

    buckets = build_buckets(constraints, len(x0))
    assert len(buckets) >= 2  # singleton-fixed + fixed+vertical
    M = 3
    x0s = [jnp.asarray(np.tile(x0[b.var_index], (M, 1))) for b in buckets]
    parss = [tuple(jnp.asarray(np.tile(p, (M, 1, 1))) for p in b.pars)
             for b in buckets]

    for precision in ("f64", "mixed"):
        fused = MultiTopologySolver([b.system for b in buckets], Config(),
                                    precision=precision)
        outs = fused.solve(x0s, parss)
        for bucket, xb, pars, out in zip(buckets, x0s, parss, outs):
            assert bool(np.asarray(out.converged).all())
            assert bool(np.asarray(out.satisfied).all())
            ref = BatchSolver(bucket.system, Config(), batch_params=True,
                              precision=precision).solve(xb, pars)
            np.testing.assert_allclose(np.asarray(out.x), np.asarray(ref.x),
                                       atol=1e-12)
            np.testing.assert_array_equal(np.asarray(out.iterations),
                                          np.asarray(ref.iterations))


def test_mixed_respects_iteration_budget():
    """coarse + refine never exceeds the caller's max_iterations."""
    constraints, x0 = _square_system()
    system64 = compile_system(constraints, n_vars=len(x0))
    system32 = system64.astype(jnp.float32)
    for budget in (1, 3, 5):
        res = solve_lm_mixed(
            system64, system32, jnp.asarray(np.asarray(x0, np.float64)),
            budget, 1e-8, 1e-12, 1e-9,
        )
        assert int(res.iterations) <= budget, (budget, int(res.iterations))


def test_mixed_inconsistent_terminates():
    """Least-squares compromise systems (residual can't reach tolerance)
    must still terminate with converged=False or step-converge, not hang."""
    p0, p1 = DatumPoint(0, 1), DatumPoint(2, 3)
    constraints = [
        Constraint.Fixed(p0.x_id, 0.0),
        Constraint.Fixed(p0.y_id, 0.0),
        Constraint.Fixed(p1.y_id, 0.0),
        Constraint.Distance(p0, p1, 4.0),
        Constraint.VerticalDistance(p0, p1, 1.0),  # contradicts p1.y = 0
    ]
    x0 = np.array([0.0, 0.0, 4.0, 0.5])
    res = _mixed_solve(constraints, x0)
    # Terminates; the compromise leaves some residual > 1e-8.
    assert np.isfinite(np.asarray(res.x)).all()


def test_api_precision_mixed_config():
    """Config(precision="mixed") routes the public solve through
    solve_lm_mixed: same solution and satisfaction as the f64 path at the
    corpus tolerance, converged at the 1e-8 f64 residual verification.
    (Iteration counts are documented as not reference-comparable.)"""
    import ezpz_jax as ez

    ids = ez.IdGenerator()
    p, q = ez.DatumPoint.new(ids), ez.DatumPoint.new(ids)
    reqs = [ez.ConstraintRequest.highest_priority(c) for c in [
        ez.Constraint.Fixed(p.id_x(), 0.0),
        ez.Constraint.Fixed(p.id_y(), 0.0),
        ez.Constraint.Fixed(q.id_x(), 3.0),
        ez.Constraint.Distance(p, q, 5.0),
    ]]
    guesses = [(0, 0.1), (1, -0.1), (2, 3.2), (3, 3.6)]
    f64 = ez.solve(reqs, guesses)
    mixed = ez.solve(reqs, guesses, ez.Config().with_precision("mixed"))
    assert mixed.converged and f64.converged
    assert mixed.unsatisfied == f64.unsatisfied == []
    np.testing.assert_allclose(np.asarray(mixed.final_values),
                               np.asarray(f64.final_values), atol=1e-6)

    import pytest
    with pytest.raises(ValueError):
        ez.Config().with_precision("f32")


def test_refine_iterations_accounting():
    """solve_lm_refine reports coarse_iterations + its own refine count:
    seeded with coarse_iterations=7 from a perturbed start that needs at
    least one refine step, the total must exceed 7 (a sign slip would
    report 7 - k; mutation-found)."""
    import jax.numpy as jnp

    from ezpz_jax.solver import solve_lm_refine

    p, q = DatumPoint(0, 1), DatumPoint(2, 3)
    cs = [Constraint.Fixed(0, 0.0), Constraint.Fixed(1, 0.0),
          Constraint.Fixed(2, 3.0), Constraint.Distance(p, q, 5.0)]
    s64 = compile_system(cs, n_vars=4)
    s32 = s64.astype(jnp.float32)
    x_coarse = jnp.asarray(np.array([0.001, -0.001, 3.0, 3.99]))
    res = solve_lm_refine(
        s64, s32, x_coarse, jnp.asarray(7, jnp.int32),
        jnp.zeros((4,), bool), 35, 1e-8, 1e-12, 1e-9,
    )
    assert bool(res.converged)
    assert int(res.iterations) > 7
