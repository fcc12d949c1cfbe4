"""Independent-oracle check: our LM vs scipy.optimize.least_squares.

The golden fixtures pin coordinates the REFERENCE produced; this file
cross-checks against a third implementation nobody here wrote. For random
well-posed systems, both optimizers must drive the same residual function
to (the same) zero — final residual norms agree and solved coordinates
match wherever the minimum is unique.
"""

import math

import numpy as np
import pytest
from scipy.optimize import least_squares

import ezpz_jax as ez
from ezpz_jax.constraints import Constraint, ConstraintRequest
from ezpz_jax.datatypes import DatumLineSegment, DatumPoint
from ezpz_jax.models.compiled import compile_system

RNG = np.random.default_rng(424242)


def _random_quad_system(rng):
    """A well-posed quadrilateral: corner pinned, two sides dimensioned,
    one diagonal fixed, angles via horizontal/vertical sides."""
    p = [DatumPoint(2 * i, 2 * i + 1) for i in range(4)]
    w = float(rng.uniform(2.0, 6.0))
    h = float(rng.uniform(2.0, 6.0))
    ox, oy = rng.uniform(-3, 3, 2)
    constraints = [
        Constraint.Fixed(p[0].x_id, float(ox)),
        Constraint.Fixed(p[0].y_id, float(oy)),
        Constraint.Horizontal(DatumLineSegment(p[0], p[1])),
        Constraint.Vertical(DatumLineSegment(p[1], p[2])),
        Constraint.Horizontal(DatumLineSegment(p[2], p[3])),
        Constraint.Vertical(DatumLineSegment(p[3], p[0])),
        Constraint.Distance(p[0], p[1], w),
        Constraint.Distance(p[1], p[2], h),
    ]
    x0 = np.array([
        ox, oy,
        ox + w + rng.uniform(-0.3, 0.3), oy + rng.uniform(-0.3, 0.3),
        ox + w + rng.uniform(-0.3, 0.3), oy + h + rng.uniform(-0.3, 0.3),
        ox + rng.uniform(-0.3, 0.3), oy + h + rng.uniform(-0.3, 0.3),
    ])
    return constraints, x0


@pytest.mark.parametrize("trial", range(4))
def test_matches_scipy_least_squares(trial):
    rng = np.random.default_rng(1000 + trial)
    constraints, x0 = _random_quad_system(rng)
    system = compile_system(constraints, n_vars=len(x0))

    # Ours.
    reqs = [ConstraintRequest.highest_priority(c) for c in constraints]
    ours = ez.solve(reqs, list(enumerate(x0)), ez.Config())
    assert ours.converged

    # scipy, driving the SAME residual function (our compiled system).
    def residual(x):
        return np.asarray(system.residual(x))

    ref = least_squares(residual, x0, method="lm", xtol=1e-14, ftol=1e-14)
    assert np.linalg.norm(ref.fun, np.inf) < 1e-8

    np.testing.assert_allclose(
        np.asarray(ours.final_values), ref.x, atol=1e-6,
        err_msg=f"trial {trial}: ours vs scipy diverge",
    )


def test_inconsistent_compromise_matches_scipy():
    """For an over-determined inconsistent system, both optimizers find the
    same least-squares compromise (same residual norm; unique minimum)."""
    p0, p1 = DatumPoint(0, 1), DatumPoint(2, 3)
    constraints = [
        Constraint.Fixed(p0.x_id, 0.0),
        Constraint.Fixed(p0.y_id, 0.0),
        Constraint.Fixed(p1.x_id, 3.0),
        Constraint.Fixed(p1.y_id, 0.0),
        Constraint.Distance(p0, p1, 4.0),  # contradicts |p1-p0| = 3
    ]
    system = compile_system(constraints, n_vars=4)
    x0 = np.array([0.1, 0.0, 3.1, 0.1])

    reqs = [ConstraintRequest.highest_priority(c) for c in constraints]
    ours = ez.solve(reqs, list(enumerate(x0)), ez.Config())

    def residual(x):
        return np.asarray(system.residual(x))

    ref = least_squares(residual, x0, method="lm", xtol=1e-14, ftol=1e-14)
    ours_cost = 0.5 * float(np.sum(residual(np.asarray(ours.final_values)) ** 2))
    assert abs(ours_cost - ref.cost) < 1e-10
    np.testing.assert_allclose(np.asarray(ours.final_values), ref.x, atol=1e-5)


def test_satisfaction_epsilon_decade():
    """EPSILON = 1e-4 (``ezpz/src/lib.rs:43``): a residual of 2.5e-4 —
    inside the decade ABOVE the tolerance — must be UNSATISFIED through
    both satisfaction paths. Pins the tolerance's decade (a 1e-3 epsilon
    would wrongly report satisfaction)."""
    import jax.numpy as jnp

    cs = [Constraint.Fixed(0, 0.0), Constraint.Fixed(0, 5e-4)]
    system = compile_system(cs, 1)
    x = jnp.array([2.5e-4])
    sat = np.asarray(system.constraint_satisfaction(x))
    assert not sat[0] and not sat[1]
    r, _deg = system.residual_and_flags(x)
    sat_r = np.asarray(system.satisfaction_from_residual(r))
    assert not sat_r[0] and not sat_r[1]
    # Well inside the tolerance IS satisfied (first constraint only).
    sat_in = np.asarray(system.constraint_satisfaction(jnp.array([1e-5])))
    assert sat_in[0] and not sat_in[1]


def test_weighted_inconsistent_matches_scipy():
    """Weights must scale residual AND Jacobian rows the same way
    (``lib.rs``: the weight multiplies the whole equation). On an
    inconsistent pair Fixed(v,0)@w=1 vs Fixed(v,1)@w=3 the weighted
    least-squares minimizer is v = 9/10 — scipy agrees; a solver that
    divides the Jacobian by the weight instead lands at v = 1/10."""
    import jax.numpy as jnp
    from ezpz_jax.config import Config
    from ezpz_jax.solver import solve_lm

    cs = [Constraint.Fixed(0, 0.0), Constraint.Fixed(0, 1.0)]
    system = compile_system(cs, 1, weights=[1.0, 3.0])
    c = Config()
    out = solve_lm(system, jnp.array([0.4]), c.max_iterations,
                   c.residual_tolerance, c.step_tolerance, c.initial_lambda)
    ref = least_squares(lambda v: [v[0] - 0.0, 3.0 * (v[0] - 1.0)],
                        [0.4], method="lm", xtol=1e-14, ftol=1e-14)
    np.testing.assert_allclose(float(out.x[0]), ref.x[0], atol=1e-9)
    np.testing.assert_allclose(float(out.x[0]), 0.9, atol=1e-9)
    # The dense Jacobian (freedom analysis path) scales rows by weight too.
    J = np.asarray(system.jacobian_dense(jnp.array([0.9])))
    np.testing.assert_allclose(J[:, 0], [1.0, 3.0])
    # And the matrix-free path (solve_lm_cg via jacobian_factors) weights
    # its per-block Jacobians identically — an unweighted Jt r would pull
    # the minimizer to 0.5 instead of 0.9.
    from ezpz_jax.solver import solve_lm_cg
    out_cg = solve_lm_cg(system, jnp.array([0.4]), c.max_iterations,
                         c.residual_tolerance, c.step_tolerance,
                         c.initial_lambda)
    np.testing.assert_allclose(float(out_cg.x[0]), 0.9, atol=1e-7)


def test_compiled_system_structural_contracts():
    """Three contracts the full mutation run showed were unpinned:
    (1) ``astype`` really retypes — the mixed path's f32 twin must not
    silently stay f64 (and same-dtype astype returns self);
    (2) ``block_row_slices`` accounts dim-2 kernel rows as nb*dim;
    (3) ``satisfaction_from_residual`` divides the weighted residual back
    to the unweighted one — a low-weight violated constraint must stay
    unsatisfied."""
    import jax.numpy as jnp

    p, q = DatumPoint(0, 1), DatumPoint(2, 3)
    cs = [Constraint.PointsCoincident(p, q), Constraint.Fixed(0, 0.0)]
    system = compile_system(cs, 4)
    s32 = system.astype(jnp.float32)
    assert s32.dtype == jnp.float32
    assert all(np.asarray(b.weight).dtype == np.float32 for b in s32.blocks)
    assert system.astype(system.dtype) is system

    slices = system.block_row_slices()
    assert system.n_rows == 3  # 2 (points_coincident) + 1 (fixed)
    assert max(hi for _lo, hi in slices) == 3
    assert sorted(hi - lo for lo, hi in slices) == [1, 2]

    cs2 = [Constraint.Fixed(0, 0.0), Constraint.Fixed(0, 1.0)]
    sys2 = compile_system(cs2, 1, weights=[1.0, 1e-3])
    x = jnp.array([1e-5])  # second constraint violated by ~1.0
    r, _deg = sys2.residual_and_flags(x)
    sat = np.asarray(sys2.satisfaction_from_residual(r))
    assert sat[0] and not sat[1]
    # The evaluation-based path agrees.
    sat_e = np.asarray(sys2.constraint_satisfaction(x))
    assert sat_e[0] and not sat_e[1]


def test_zero_weight_constraint_uses_exact_satisfaction():
    """``all_weights_positive`` gates the fast satisfaction path (divide
    the weighted residual by the weight): with a weight of EXACTLY zero
    that division is 0/0, so the solver must fall back to re-evaluating
    constraints at the solution. A satisfied weight-0 duplicate must not
    be reported unsatisfied — and the weighted residual itself must carry
    w * res (here [0, 3], not [0, 1/3])."""
    import jax.numpy as jnp
    from ezpz_jax.constraints import ConstraintRequest

    reqs = [
        ConstraintRequest.highest_priority(Constraint.Fixed(0, 0.5)),
        ConstraintRequest.highest_priority(
            Constraint.Fixed(0, 0.5)).with_weight(0.0),
    ]
    out = ez.solve(reqs, [(0, 0.37)])
    assert out.converged
    assert out.unsatisfied == []  # both exactly satisfiable at x = 0.5

    # Direct weighted-residual value pin (residual and residual_and_flags).
    system = compile_system(
        [Constraint.Fixed(0, 0.0), Constraint.Fixed(0, 1.0)], 1,
        weights=[1.0, 3.0])
    x = jnp.array([0.0])
    np.testing.assert_allclose(np.asarray(system.residual(x)), [0.0, -3.0])
    r, _deg = system.residual_and_flags(x)
    np.testing.assert_allclose(np.asarray(r), [0.0, -3.0])
