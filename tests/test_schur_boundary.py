"""Distributed (matrix-free CG) boundary solve for ShardedSchurSolver and
the large-boundary stress case: a 2-D grid sketch
where the boundary is as large as (or larger than) the interior — the
regime where a replicated dense (n_b, n_b) Schur solve stops scaling.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import ezpz_jax as ez
from ezpz_jax.config import Config
from ezpz_jax.constraints import Constraint
from ezpz_jax.datatypes import DatumPoint
from ezpz_jax.models.compiled import compile_system
from ezpz_jax.parallel import ShardedSchurSolver
from ezpz_jax.solver import solve_lm

from .test_parallel import _coupled_chain_problem


def _need_devices(n=8):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} devices")


def _grid_problem(G=6):
    """G x G grid of points: first column fully fixed, unit distances to
    the right neighbor, ScalarEqual ties on vertical neighbors' y. With a
    1-D row partition every vertical tie spans a cut, so most variables
    are boundary — the dense-Schur worst case."""
    n_vars = G * G * 2
    constraints = []
    x0 = np.zeros(n_vars)
    rng = np.random.default_rng(0)

    def pt(r, c):
        base = (r * G + c) * 2
        return DatumPoint(base, base + 1)

    for r in range(G):
        constraints.append(Constraint.Fixed(pt(r, 0).x_id, 0.0))
        constraints.append(Constraint.Fixed(pt(r, 0).y_id, float(r)))
        for c in range(G - 1):
            constraints.append(Constraint.Distance(pt(r, c), pt(r, c + 1), 1.0))
            constraints.append(Constraint.Horizontal(
                ez.DatumLineSegment(pt(r, c), pt(r, c + 1))))
    for r in range(G - 1):
        for c in range(G):
            constraints.append(
                Constraint.ScalarEqual(pt(r, c).y_id + 0, pt(r + 1, c).y_id))
    for r in range(G):
        for c in range(G):
            base = (r * G + c) * 2
            x0[base] = c + rng.uniform(-0.2, 0.2)
            x0[base + 1] = r + rng.uniform(-0.2, 0.2)
    return constraints, x0


def _global(constraints, x0):
    c = Config()
    system = compile_system(constraints, len(x0))
    return solve_lm(system, jnp.asarray(x0), c.max_iterations,
                    c.residual_tolerance, c.step_tolerance, c.initial_lambda)


def test_cg_boundary_matches_dense_chain():
    """boundary_solver="cg" reaches the same solution as "dense" on the
    coupled chain (tight cg_tol -> same LM trajectory)."""
    _need_devices()
    constraints, x0 = _coupled_chain_problem()
    dense = ShardedSchurSolver(constraints, len(x0)).solve(x0)
    cg = ShardedSchurSolver(constraints, len(x0),
                            boundary_solver="cg").solve(x0)
    assert cg["converged"]
    np.testing.assert_allclose(cg["x"], dense["x"], atol=1e-7)
    assert cg["iterations"] == dense["iterations"]


def test_grid_large_boundary_converges():
    """2-D grid, 1-D partition: boundary >= interior, both boundary
    solvers still converge to the global solution."""
    _need_devices()
    constraints, x0 = _grid_problem(G=6)
    ref = _global(constraints, x0)
    assert bool(ref.converged)
    for solver_kind in ("dense", "cg"):
        s = ShardedSchurSolver(constraints, len(x0),
                               boundary_solver=solver_kind)
        out = s.solve(x0)
        assert out["converged"], solver_kind
        assert out["n_boundary"] >= s.n_i, (
            "stress case must have boundary >= interior",
            out["n_boundary"], s.n_i)
        np.testing.assert_allclose(out["x"], np.asarray(ref.x), atol=1e-6,
                                   err_msg=solver_kind)


def test_all_boundary_degenerate_partition():
    """Tiny system over many devices: EVERY variable is boundary and
    interiors are empty — the partition degenerates to a pure distributed
    boundary solve and must still work (n_i == 0 edge)."""
    _need_devices()
    p, q = DatumPoint(0, 1), DatumPoint(2, 3)
    r, s = DatumPoint(4, 5), DatumPoint(6, 7)
    cs = [Constraint.Fixed(0, 0.0), Constraint.Fixed(1, 0.0),
          Constraint.Distance(p, q, 2.0),
          Constraint.Fixed(4, 1.0), Constraint.Fixed(5, 0.0),
          Constraint.Distance(r, s, 2.0),
          Constraint.ScalarEqual(3, 7)]
    x0 = np.array([0.0, 0.0, 1.4, 1.5, 1.0, 0.0, 2.4, 1.6])
    for solver_kind in ("dense", "cg"):
        solver = ShardedSchurSolver(cs, 8, boundary_solver=solver_kind)
        out = solver.solve(x0)
        assert out["converged"], solver_kind
        assert solver.n_i <= 1  # 8 vars over 8 devices: (almost) all boundary


def test_cg_boundary_mixed_precision():
    _need_devices()
    constraints, x0 = _coupled_chain_problem()
    ref = ShardedSchurSolver(constraints, len(x0)).solve(x0)
    out = ShardedSchurSolver(constraints, len(x0), precision="mixed",
                             boundary_solver="cg").solve(x0)
    assert out["converged"]
    np.testing.assert_allclose(out["x"], ref["x"], atol=1e-5)
