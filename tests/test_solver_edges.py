"""Regression tests for solver edge cases found by adversarial review."""

import numpy as np
import jax.numpy as jnp

import ezpz_jax  # noqa: F401
from ezpz_jax.config import Config
from ezpz_jax.constraints import Constraint
from ezpz_jax.datatypes import DatumLineSegment, DatumPoint
from ezpz_jax.models.compiled import compile_system
from ezpz_jax.ops.kernels import KERNELS
from ezpz_jax.solver import solve_gauss_newton, solve_lm


def test_budget_boundary_reports_unconverged():
    """The reference checks the residual only at the TOP of each of its
    max_iterations iterations (newton.rs:47-60,141-144): a solve whose LAST
    allowed step lands inside tolerance still reports converged=False with
    iterations=max_iterations. A post-loop recheck must not differ."""
    c = [Constraint.Fixed(0, 3.0)]
    system = compile_system(c, n_vars=1)
    res = solve_lm(system, jnp.asarray(np.array([10.0])), 1, 1e-8, 1e-12, 1e-9)
    # The single allowed (linear) step solves it exactly...
    assert float(jnp.max(jnp.abs(res.residual))) <= 1e-8
    # ...but the budget is exhausted before the next top-of-iteration check.
    assert not bool(res.converged)
    assert int(res.iterations) == 1

    # One more iteration of budget: now the check happens and reports 1.
    res2 = solve_lm(system, jnp.asarray(np.array([10.0])), 2, 1e-8, 1e-12, 1e-9)
    assert bool(res2.converged)
    assert int(res2.iterations) == 1


def test_gauss_newton_factorization_failure_not_converged():
    """A non-SPD normal-equations matrix (underconstrained system, zero
    damping) zero-fills the step; that must NOT register as step-size
    convergence at the unsolved point."""
    p, q = DatumPoint(0, 1), DatumPoint(2, 3)
    # Only a distance constraint: JtJ is rank-1 on 4 vars -> singular.
    c = [Constraint.Distance(p, q, 4.0)]
    system = compile_system(c, n_vars=4)
    x0 = jnp.asarray(np.array([0.0, 0.0, 1.0, 0.0]))
    res = solve_gauss_newton(system, x0, 5, 1e-8, 1e-12, 0.0)
    assert not bool(res.converged)
    # x frozen at the (unsolved) start, not silently accepted.
    assert float(jnp.max(jnp.abs(res.x - x0))) == 0.0


def test_gauss_newton_solves_nonlinear_system():
    """GN success path (newton.rs:150-228 is retained alongside LM): a
    well-conditioned nonlinear system must converge to the same solution
    LM finds, with every step taken (no accept/reject). Pins the GN loop's
    damped matrix, update, and convergence logic — found untested by a
    tools/mutate.py run (mutants of the GN body all survived)."""
    p, q = DatumPoint(0, 1), DatumPoint(2, 3)
    c = [
        Constraint.Fixed(0, 0.0),
        Constraint.Fixed(1, 0.0),
        Constraint.Fixed(2, 3.0),
        Constraint.Distance(p, q, 5.0),
    ]
    system = compile_system(c, n_vars=4)
    x0 = jnp.asarray(np.array([0.1, -0.1, 3.2, 3.6]))
    gn = solve_gauss_newton(system, x0, 35, 1e-8, 1e-12, 1e-9)
    assert bool(gn.converged)
    assert float(jnp.max(jnp.abs(gn.residual))) <= 1e-8
    lm = solve_lm(system, x0, 35, 1e-8, 1e-12, 1e-9)
    np.testing.assert_allclose(np.asarray(gn.x), np.asarray(lm.x), atol=1e-7)
    # y = +4 branch (guess above the axis), x pinned by the Fixed rows.
    np.testing.assert_allclose(np.asarray(gn.x), [0.0, 0.0, 3.0, 4.0],
                               atol=1e-7)
    assert 1 <= int(gn.iterations) <= 35


def test_symmetric_degenerate_mirror_line_stays_finite():
    """Exactly coincident mirror-line endpoints: the reference's residual
    divides 0/0 and NaNs; ours deliberately stays finite and flags the
    degeneracy instead (see k_symmetric)."""
    spec = KERNELS["symmetric"]
    v = jnp.asarray(np.array([0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 2.0, 0.0]))
    res, deg = spec.fn(v, jnp.zeros((0,)))
    assert bool(deg)
    assert np.isfinite(np.asarray(res)).all()


def test_solve_lm_accepts_f64_guess_on_f32_system():
    """x0 dtype must not leak into the loop carry (latent trace-time
    mismatch): an f64 guess on an f32 system casts cleanly."""
    c = [Constraint.Fixed(0, 1.5)]
    system = compile_system(c, n_vars=1, dtype=jnp.float32)
    res = solve_lm(system, jnp.asarray(np.array([0.0], np.float64)),
                   10, 1e-5, 1e-7, 1e-9)
    assert bool(res.converged)
    assert res.x.dtype == jnp.float32


def test_damping_floor_rescue_adds_positive_shift():
    """The f32 singular-rescue retry must ADD the floored damping
    (jtj + max(lam, floor)*eye, damped_spd_solve): on a matrix that is
    indefinite by f32 round-off (off-diagonal 1+1e-7 > diagonal 1), the
    raw lam=1e-9 factorization fails and only the +floor retry is SPD.
    A sign flip on the shift leaves the retry indefinite too, turning a
    rescuable lane into a hard failure (mutation-found: the rescue branch
    was only ever exercised where the raw solve already succeeded)."""
    from ezpz_jax.ops.linalg import spd_solve
    from ezpz_jax.solver import damped_spd_solve

    a, o = np.float32(1.0), np.float32(1.0 + 1e-7)
    jtj = jnp.asarray([[a, o], [o, a]], jnp.float32)
    eye = jnp.eye(2, dtype=jnp.float32)
    b = jnp.asarray([1.0, 2.0], jnp.float32)
    # Precondition: this matrix genuinely needs the rescue.
    _, raw_fail = spd_solve(jtj + jnp.float32(1e-9) * eye, b)
    assert bool(raw_fail), "raw lam must fail or the rescue is untested"
    d, fail = damped_spd_solve(jtj, jnp.float32(1e-9), eye, b)
    assert not bool(fail)
    assert np.isfinite(np.asarray(d)).all()
    # The returned step solves the floored system.
    floor = np.float32(1e-6) * float(jnp.max(jnp.abs(jnp.diagonal(jtj))))
    lhs = np.asarray(jtj + np.float32(max(1e-9, floor)) * eye, np.float64)
    np.testing.assert_allclose(lhs @ np.asarray(d, np.float64),
                               np.asarray(b, np.float64), atol=1e-3)


def test_gauss_newton_residual_check_is_inclusive():
    """GN's top-of-iteration convergence test is ``max|r| <= rtol``
    (inclusive, matching solve_lm and newton.rs). Engineered exact tie:
    re-run with rtol set to the previously achieved residual — the run
    must stop at the same iteration with the same x, not take an extra
    step past the tie (mutation-found boundary)."""
    p, q = DatumPoint(0, 1), DatumPoint(2, 3)
    c = [
        Constraint.Fixed(0, 0.0),
        Constraint.Fixed(1, 0.0),
        Constraint.Fixed(2, 3.0),
        Constraint.Distance(p, q, 5.0),
    ]
    system = compile_system(c, n_vars=4)
    x0 = jnp.asarray(np.array([0.1, -0.1, 3.2, 3.6]))
    g1 = solve_gauss_newton(system, x0, 35, 1e-8, 1e-12, 1e-9)
    tie = float(jnp.max(jnp.abs(g1.residual)))
    assert tie > 0.0
    g2 = solve_gauss_newton(system, x0, 35, tie, 1e-12, 1e-9)
    assert bool(g2.converged)
    assert int(g2.iterations) == int(g1.iterations)
    assert bool(jnp.all(g2.x == g1.x))


def test_mixed_phase_defaults_are_pinned():
    """The documented mixed-path phase budgets and coarse target
    (solver.py docstrings). These are
    performance knobs whose mutations are outcome-invisible on converging
    fixtures (the f64 refine phase rescues any coarse point), so the
    contract is pinned structurally."""
    import inspect

    from ezpz_jax.solver import solve_lm_mixed, solve_lm_refine

    pm = inspect.signature(solve_lm_mixed).parameters
    assert pm["coarse_tolerance"].default == 5e-6
    assert pm["refine_iterations"].default == 6
    assert pm["coarse_max_iterations"].default == 20
    pr = inspect.signature(solve_lm_refine).parameters
    assert pr["refine_iterations"].default == 6


def test_step_tolerance_boundary_is_inclusive():
    """Step-size convergence is ``step_inf <= stol`` (inclusive) in both
    LM and GN. Engineered exact tie: Fixed(0, 3) from x0=10 with zero
    damping takes the step d = 7.0 exactly; at stol = 7.0 both loops must
    stop AT that iteration (iterations == 0, converged) rather than take
    another look (mutation-found boundary)."""
    c = [Constraint.Fixed(0, 3.0)]
    system = compile_system(c, n_vars=1)
    x0 = jnp.asarray(np.array([10.0]))
    lm = solve_lm(system, x0, 5, 1e-8, 7.0, 0.0)
    assert bool(lm.converged) and int(lm.iterations) == 0
    assert float(lm.x[0]) == 3.0
    gn = solve_gauss_newton(system, x0, 5, 1e-8, 7.0, 0.0)
    assert bool(gn.converged) and int(gn.iterations) == 0
    assert float(gn.x[0]) == 3.0


def test_gauss_newton_budget_is_strict():
    """GN's loop condition is ``it < max_iterations`` (strict): with a
    budget of 1, the result is exactly one damped step from x0 and
    reports converged=False — an inclusive bound would sneak in a second
    iteration whose top-of-loop residual check then reports converged
    (mutation-found)."""
    from ezpz_jax.solver import damped_spd_solve

    p, q = DatumPoint(0, 1), DatumPoint(2, 3)
    c = [Constraint.Fixed(0, 0.0), Constraint.Fixed(1, 0.0),
         Constraint.Fixed(2, 3.0), Constraint.Distance(p, q, 5.0)]
    system = compile_system(c, n_vars=4)
    x0 = jnp.asarray(np.array([0.1, -0.1, 3.2, 3.6]))
    g1 = solve_gauss_newton(system, x0, 1, 1e-8, 1e-12, 1e-9)
    assert not bool(g1.converged)
    _r, jtj, jtr, _d = system.normal_equations(x0, None)
    eye = jnp.eye(4, dtype=system.dtype)
    d, _fail = damped_spd_solve(jtj, jnp.asarray(1e-9, system.dtype), eye, -jtr)
    np.testing.assert_allclose(np.asarray(g1.x), np.asarray(x0 + d),
                               rtol=0, atol=1e-14)


def test_init_state_lambda_dtype_contract():
    """_init_state honours lam_dtype (solve_lm_refine carries its lambda
    in the f32 working dtype while the system is f64); None falls back to
    the system dtype (mutation-found: `lam_dtype or dtype`)."""
    from ezpz_jax.solver import _init_state

    c = [Constraint.Fixed(0, 3.0)]
    system = compile_system(c, n_vars=1)
    x0 = jnp.asarray(np.array([10.0]))
    st32 = _init_state(system, x0, 1e-9, lam_dtype=jnp.float32)
    assert st32.lam.dtype == jnp.float32
    st = _init_state(system, x0, 1e-9)
    assert st.lam.dtype == system.dtype
