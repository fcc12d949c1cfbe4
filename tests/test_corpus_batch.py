"""Every corpus fixture through the f64 BatchSolver: lane 0 of a 3-lane
batch equals solver.solve_lm on the same compiled system (same evaluator
and normal-equation tier) — the vmapped while_loop freezes finished lanes
and changes nothing else.

Where the Jacobian at the solution is rank-deficient (an underconstrained
sketch), the damped step solves (JtJ + lambda I) with lambda ~ 1e-9, which
magnifies the last-bit rounding differences between batched and single
contractions ~1e9-fold along the free directions; there the lanes must
still take the same iterations and land within 1e-6 on the same solution
manifold."""

import jax.numpy as jnp
import numpy as np
import pytest

import ezpz_jax  # noqa: F401
from ezpz_jax.batch import BatchSolver, _maybe_unroll, _pick_spd
from ezpz_jax.config import Config
from ezpz_jax.dof import freedom_analysis
from ezpz_jax.solver import solve_lm

from .corpus import CASES, fixture_system, three_lanes


@pytest.mark.parametrize("case", CASES)
def test_batch_lane_matches_solve_lm(case):
    system, x0 = fixture_system(case)
    cfg = Config()
    res = BatchSolver(system, cfg).solve(jnp.asarray(three_lanes(x0)))
    ref = solve_lm(_maybe_unroll(system), jnp.asarray(x0), cfg.max_iterations,
                   cfg.residual_tolerance, cfg.step_tolerance,
                   cfg.initial_lambda, spd=_pick_spd(system))
    assert int(np.asarray(res.iterations)[0]) == int(ref.iterations)
    assert bool(np.asarray(res.converged)[0]) == bool(ref.converged)
    free = freedom_analysis(np.asarray(system.jacobian_dense(ref.x)))
    atol = 1e-6 if free.is_underconstrained() else 1e-12
    np.testing.assert_allclose(np.asarray(res.x)[0], np.asarray(ref.x),
                               rtol=0, atol=atol)
