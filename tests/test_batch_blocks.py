"""Batched fleet solving and connected-component decomposition tests.

Key invariant (SURVEY.md section 4): a vmapped batch of solves must equal a
loop of single solves, and the block-decomposed solve of a separable system
must match the global solve.
"""

import numpy as np
import pytest

import jax.numpy as jnp

import ezpz_jax as ez
from ezpz_jax.batch import BatchSolver
from ezpz_jax.config import Config
from ezpz_jax.constraints import Constraint, ConstraintRequest
from ezpz_jax.datatypes import DatumPoint
from ezpz_jax.models.blocks import BlockSolver, connected_components
from ezpz_jax.models.compiled import compile_system

from .helpers import CASES_DIR


def _distance_system():
    p = DatumPoint(0, 1)
    q = DatumPoint(2, 3)
    cs = [
        Constraint.Fixed(0, 0.0),
        Constraint.Fixed(1, 0.0),
        Constraint.Distance(p, q, 4.0),
    ]
    return compile_system(cs, 4), cs


def test_batch_equals_loop_of_singles():
    system, cs = _distance_system()
    rng = np.random.default_rng(7)
    B = 16
    x0 = np.zeros((B, 4))
    x0[:, 2:] = rng.uniform(1.0, 8.0, size=(B, 2))

    solver = BatchSolver(system, Config())
    batch = solver.solve(jnp.asarray(x0))

    from ezpz_jax.solver import solve_lm

    for i in range(B):
        single = solve_lm(system, jnp.asarray(x0[i]), 35, 1e-8, 1e-12, 1e-9)
        np.testing.assert_allclose(np.asarray(single.x), np.asarray(batch.x[i]), atol=1e-12)
        assert int(single.iterations) == int(batch.iterations[i])
        assert bool(single.converged) == bool(batch.converged[i])


def test_batch_with_per_sketch_params():
    system, cs = _distance_system()
    B = 8
    x0 = np.tile(np.array([0.0, 0.0, 3.0, 4.0]), (B, 1))
    # Per-sketch distance targets; blocks sorted by kernel name:
    # distance then fixed.
    targets = np.linspace(1.0, 8.0, B)
    pars = []
    for b in system.blocks:
        base = np.tile(b.par, (B, 1, 1))
        if b.spec.name == "distance":
            base[:, 0, 0] = targets
        pars.append(jnp.asarray(base))
    solver = BatchSolver(system, Config(), batch_params=True)
    res = solver.solve(jnp.asarray(x0), tuple(pars))
    got = np.hypot(np.asarray(res.x)[:, 2], np.asarray(res.x)[:, 3])
    np.testing.assert_allclose(got, targets, atol=1e-8)
    assert bool(np.asarray(res.converged).all())


def test_connected_components():
    # Two independent distance systems + one floating constraint set.
    pa, qa = DatumPoint(0, 1), DatumPoint(2, 3)
    pb, qb = DatumPoint(4, 5), DatumPoint(6, 7)
    cs = [
        Constraint.Distance(pa, qa, 1.0),
        Constraint.Distance(pb, qb, 2.0),
        Constraint.Fixed(0, 0.0),
        Constraint.Fixed(4, 0.0),
    ]
    comps = connected_components(cs, 8)
    assert len(comps) == 2
    assert comps[0].var_ids == [0, 1, 2, 3]
    assert comps[1].var_ids == [4, 5, 6, 7]
    assert comps[0].constraint_ids == [0, 2]
    assert comps[1].constraint_ids == [1, 3]


def test_block_solve_matches_global_solve():
    """Decomposed solve == monolithic solve on a separable system."""
    import os

    from ezpz_jax.textual import Problem

    txt = open(os.path.join(CASES_DIR, "two_rectangles", "problem.md")).read()
    sys_ = Problem.from_str(txt).to_constraint_system()
    out_global = sys_.solve()

    constraints = [r.constraint for r in sys_.constraints]
    x0 = np.zeros(len(sys_.initial_guesses))
    for vid, val in sys_.initial_guesses:
        x0[vid] = val
    solver = BlockSolver(constraints, len(x0))
    res = solver.solve(x0)
    assert res.n_components == 2  # the two rectangles are independent
    assert res.converged
    assert res.satisfied.all()
    np.testing.assert_allclose(res.x, out_global.final_values, atol=1e-7)


def test_massive_parallel_system_blocks():
    import os

    from ezpz_jax.textual import Problem

    txt = open(os.path.join(CASES_DIR, "massive_parallel_system", "problem.md")).read()
    sys_ = Problem.from_str(txt).to_constraint_system()
    constraints = [r.constraint for r in sys_.constraints]
    x0 = np.zeros(len(sys_.initial_guesses))
    for vid, val in sys_.initial_guesses:
        x0[vid] = val
    solver = BlockSolver(constraints, len(x0))
    res = solver.solve(x0)
    assert res.converged
    assert res.satisfied.all()
    # Matches the reference's reported convergence (2 LM iterations,
    # README.md:37-41).
    assert res.iterations == 2
