"""Multi-device tests on a virtual 8-device CPU mesh.

conftest.py sets XLA_FLAGS=--xla_force_host_platform_device_count=8.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import ezpz_jax as ez
from ezpz_jax.batch import BatchSolver
from ezpz_jax.config import Config
from ezpz_jax.constraints import Constraint
from ezpz_jax.datatypes import DatumPoint
from ezpz_jax.models.compiled import compile_system
from ezpz_jax.parallel import FleetSolver, ShardedSchurSolver


def _need_devices(n=8):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} devices")


def _distance_system():
    p = DatumPoint(0, 1)
    q = DatumPoint(2, 3)
    cs = [
        Constraint.Fixed(0, 0.0),
        Constraint.Fixed(1, 0.0),
        Constraint.Distance(p, q, 4.0),
    ]
    return compile_system(cs, 4), cs


def test_fleet_solver_matches_batch():
    _need_devices()
    system, _ = _distance_system()
    rng = np.random.default_rng(3)
    B = 64  # divisible by 8
    x0 = np.zeros((B, 4))
    x0[:, 2:] = rng.uniform(1.0, 9.0, size=(B, 2))

    fleet = FleetSolver(system)
    res_fleet = fleet.solve(jnp.asarray(x0))

    local = BatchSolver(system, Config())
    res_local = local.solve(jnp.asarray(x0))

    np.testing.assert_allclose(np.asarray(res_fleet.x), np.asarray(res_local.x), atol=1e-12)
    np.testing.assert_array_equal(
        np.asarray(res_fleet.iterations), np.asarray(res_local.iterations)
    )
    assert bool(np.asarray(res_fleet.converged).all())


def test_fleet_solver_mixed_matches_batch():
    """FleetSolver(precision='mixed') shards BatchSolver's OWN vmapped
    mixed-precision callable: results are bit-identical to the local
    solver (the mixed path and the multi-device path must not be
    disjoint)."""
    _need_devices()
    system, _ = _distance_system()
    rng = np.random.default_rng(5)
    B = 64
    x0 = np.zeros((B, 4))
    x0[:, 2:] = rng.uniform(1.0, 9.0, size=(B, 2))
    pars = tuple(
        jnp.asarray(np.tile(np.asarray(b.par), (B, 1, 1)))
        for b in system.blocks
    )

    fleet = FleetSolver(system, batch_params=True, precision="mixed")
    res_fleet = fleet.solve(jnp.asarray(x0), pars)
    local = BatchSolver(system, Config(), batch_params=True, precision="mixed")
    res_local = local.solve(jnp.asarray(x0), pars)

    np.testing.assert_array_equal(
        np.asarray(res_fleet.x), np.asarray(res_local.x))
    np.testing.assert_array_equal(
        np.asarray(res_fleet.iterations), np.asarray(res_local.iterations))
    assert bool(np.asarray(res_fleet.converged).all())
    assert bool(np.asarray(res_fleet.satisfied).all())


def _coupled_chain_problem(n_blocks=8, pts_per_block=4):
    """n_blocks chains of points; inside each chain: fixes + distances.
    Chains couple through ScalarEqual constraints between neighboring chains'
    end coordinates -> genuine cross-partition (boundary) structure."""
    constraints = []
    n_vars = n_blocks * pts_per_block * 2
    x0 = np.zeros(n_vars)
    rng = np.random.default_rng(0)
    for b in range(n_blocks):
        base = b * pts_per_block * 2
        pts = [DatumPoint(base + 2 * i, base + 2 * i + 1) for i in range(pts_per_block)]
        constraints.append(Constraint.Fixed(pts[0].x_id, float(b)))
        constraints.append(Constraint.Fixed(pts[0].y_id, 0.0))
        for i in range(pts_per_block - 1):
            constraints.append(Constraint.Distance(pts[i], pts[i + 1], 1.0))
            constraints.append(Constraint.Horizontal(
                ez.DatumLineSegment(pts[i], pts[i + 1])
            ))
        x0[base: base + 2 * pts_per_block: 2] = float(b) + np.arange(pts_per_block) * 1.1
        x0[base + 1: base + 2 * pts_per_block: 2] = rng.uniform(-0.3, 0.3, pts_per_block)
    # Couple: each chain's last point y equals next chain's first point y.
    for b in range(n_blocks - 1):
        last_y = b * pts_per_block * 2 + (pts_per_block - 1) * 2 + 1
        next_first_y = (b + 1) * pts_per_block * 2 + 1
        constraints.append(Constraint.ScalarEqual(last_y, next_first_y))
    return constraints, x0


def test_sharded_schur_matches_global_solve():
    _need_devices()
    constraints, x0 = _coupled_chain_problem()
    n_vars = len(x0)

    # Global single-device reference solve.
    reqs = [ez.ConstraintRequest.highest_priority(c) for c in constraints]
    guesses = [(i, float(x0[i])) for i in range(n_vars)]
    global_out = ez.solve(reqs, guesses, Config())
    assert global_out.is_satisfied()

    solver = ShardedSchurSolver(constraints, n_vars)
    res = solver.solve(x0)
    assert res["n_boundary"] > 0, "problem should have genuine coupling"
    assert res["converged"]
    assert res["satisfied"].all()
    # Same least-squares solution (well-determined system).
    np.testing.assert_allclose(res["x"], global_out.final_values, atol=1e-6)


def test_sharded_schur_mixed_precision():
    """precision='mixed' (f32 linear algebra, f64 residuals): same solution
    at the f64-verified tolerance as the pure-f64 sharded solve."""
    from jax.sharding import Mesh

    constraints, x0 = _coupled_chain_problem()
    mesh = Mesh(np.array(jax.devices()[:4]), ("d",))
    ref = ShardedSchurSolver(constraints, len(x0), mesh=mesh).solve(x0)
    mix = ShardedSchurSolver(constraints, len(x0), mesh=mesh,
                             precision="mixed").solve(x0)
    assert mix["converged"]
    assert mix["satisfied"].all()
    np.testing.assert_allclose(mix["x"], ref["x"], atol=1e-6)


def test_sharded_schur_no_coupling():
    """Degenerate case: no cross-partition constraints at all."""
    _need_devices()
    constraints, x0 = _coupled_chain_problem()
    constraints = [c for c in constraints if c.kind != Constraint.SCALAR_EQUAL]
    solver = ShardedSchurSolver(constraints, len(x0))
    res = solver.solve(x0)
    assert res["n_boundary"] == 0
    assert res["converged"]
    assert res["satisfied"].all()


def test_sharded_schur_singular_interior_terminates():
    """Rank-deficient interior + initial_lambda=0: the undamped normal
    equations are singular, so the first Schur step either trips the NaN
    fail flag (which, since the packed-collective change, rides in the
    trial evaluation's psum rather than an eager pmax) or survives on the
    sanitized zero pivot and gets rejected on merit. Either way the solve
    must TERMINATE with finite outputs — no NaN may leak through the psum
    into the replicated state — and report an honest converged flag."""
    _need_devices()
    constraints, x0 = _coupled_chain_problem()
    # Orphan a rotation freedom: drop ONE Horizontal so its point is held
    # by the distance constraint alone (rank-1 2x2 block in JtJ).
    kept, dropped = [], False
    for c in constraints:
        if not dropped and c.kind == Constraint.HORIZONTAL:
            dropped = True
            continue
        kept.append(c)
    assert dropped
    cfg = Config(initial_lambda=0.0, max_iterations=8)
    solver = ShardedSchurSolver(kept, len(x0), config=cfg)
    res = solver.solve(x0)
    assert np.isfinite(np.asarray(res["x"])).all()
    assert int(res["iterations"]) <= 8
