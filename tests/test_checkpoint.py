"""Checkpoint/resume tests for the sharded Schur solver (SURVEY.md section 5:
the accelerator build's checkpointing niche — giant sharded solves)."""

import os

import numpy as np
import jax
from jax.sharding import Mesh

import ezpz_jax  # noqa: F401
from ezpz_jax.checkpoint import load_state, save_state, topology_fingerprint
from ezpz_jax.config import Config
from ezpz_jax.constraints import Constraint
from ezpz_jax.datatypes import DatumLineSegment, DatumPoint
from ezpz_jax.parallel import ShardedSchurSolver


def _chain(n_points):
    from ezpz_jax.fixtures import horizontal_chain

    return horizontal_chain(n_points, x_spacing=1.3, x_offset=0.21, y_offset=0.17)


def _solver(constraints, n_vars, n_dev=4):
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("d",))
    return ShardedSchurSolver(constraints, n_vars, mesh=mesh, config=Config())


def test_checkpointed_matches_plain(tmp_path):
    constraints, x0 = _chain(12)
    solver = _solver(constraints, len(x0))
    plain = solver.solve(x0)
    ck = str(tmp_path / "solve.npz")
    out = solver.solve_checkpointed(x0, ck, checkpoint_every=1)
    assert out["converged"]
    assert out["satisfied"].all()
    np.testing.assert_allclose(out["x"], plain["x"], atol=1e-9)
    # A finished solve removes its checkpoint: re-invoking the same solve
    # starts fresh instead of "resuming" from the completed state.
    assert not os.path.exists(ck)
    again = solver.solve_checkpointed(x0, ck, checkpoint_every=1)
    assert again["iterations"] == out["iterations"]
    np.testing.assert_allclose(again["x"], out["x"], atol=0)


def test_resume_from_partial_checkpoint(tmp_path):
    """Simulate preemption: run exactly one 1-iteration segment by hand,
    persist it, then let solve_checkpointed resume and finish."""
    constraints, x0 = _chain(12)
    solver = _solver(constraints, len(x0))
    ck = str(tmp_path / "partial.npz")

    fp = topology_fingerprint(solver.cons_map, solver.layout.local_to_global)
    x_i0, x_b0 = solver._scatter_x(x0)
    deg0 = np.zeros((solver.layout.n_devices, solver.n_cons_max + 1), dtype=bool)
    (x_i, x_b, _its, _conv, deg, _sat, lam, it, finished) = solver._run_segment(
        x_i0, x_b0, Config().initial_lambda, 0, deg0, 1
    )
    assert int(it) == 1 and not bool(finished)
    # An exhausted SEGMENT reports its own limit, not the closure's
    # max_iterations — the intermediate count must not read as a full
    # 35-iteration budget blowout.
    assert int(_its) == 1
    save_state(ck, fp, np.asarray(x_i), np.asarray(x_b), float(lam), int(it),
               np.asarray(deg))

    out = solver.solve_checkpointed(x0, ck, checkpoint_every=2)
    assert out["converged"]
    assert out["satisfied"].all()
    plain = solver.solve(x0)
    np.testing.assert_allclose(out["x"], plain["x"], atol=1e-9)
    # Total iterations (resumed + finishing segments) match the plain solve.
    assert out["iterations"] == plain["iterations"]


def test_changed_values_invalidate_checkpoint(tmp_path):
    """Same topology, different constraint parameters: the fingerprint
    covers values, so the stale checkpoint must be ignored, not resumed."""
    constraints, x0 = _chain(10)
    solver = _solver(constraints, len(x0))
    ck = str(tmp_path / "values.npz")
    solver.solve_checkpointed(x0, ck, checkpoint_every=2)

    # Change one Distance target (identical topology) and re-solve.
    changed = list(constraints)
    changed[2] = Constraint.Distance(DatumPoint(0, 1), DatumPoint(2, 3), 2.0)
    solver2 = _solver(changed, len(x0))
    out = solver2.solve_checkpointed(x0, ck, checkpoint_every=2)
    assert out["converged"] and out["satisfied"].all()
    plain = solver2.solve(x0)
    np.testing.assert_allclose(out["x"], plain["x"], atol=1e-9)


def test_checkpoint_every_must_be_positive(tmp_path):
    constraints, x0 = _chain(8)
    solver = _solver(constraints, len(x0))
    import pytest

    with pytest.raises(ValueError):
        solver.solve_checkpointed(x0, str(tmp_path / "x.npz"), checkpoint_every=0)


def test_wrong_topology_checkpoint_ignored(tmp_path):
    constraints, x0 = _chain(12)
    solver = _solver(constraints, len(x0))
    ck = str(tmp_path / "other.npz")
    # A checkpoint written for a DIFFERENT system must be ignored.
    other_constraints, other_x0 = _chain(10)
    other = _solver(other_constraints, len(other_x0))
    other.solve_checkpointed(other_x0, ck, checkpoint_every=3)

    out = solver.solve_checkpointed(x0, ck, checkpoint_every=3)
    assert out["converged"] and out["satisfied"].all()


def test_corrupt_checkpoint_ignored(tmp_path):
    constraints, x0 = _chain(8)
    solver = _solver(constraints, len(x0))
    ck = str(tmp_path / "corrupt.npz")
    with open(ck, "wb") as f:
        f.write(b"not an npz at all")
    out = solver.solve_checkpointed(x0, ck, checkpoint_every=4)
    assert out["converged"] and out["satisfied"].all()


def test_load_state_roundtrip(tmp_path):
    ck = str(tmp_path / "rt.npz")
    fp = topology_fingerprint(np.arange(6).reshape(2, 3))
    x_i = np.random.default_rng(0).normal(size=(2, 5))
    x_b = np.array([1.0, 2.0])
    deg = np.zeros((2, 4), dtype=bool)
    save_state(ck, fp, x_i, x_b, 1e-7, 3, deg)
    got = load_state(ck, fp)
    assert got is not None
    np.testing.assert_array_equal(got[0], x_i)
    np.testing.assert_array_equal(got[1], x_b)
    assert got[2] == 1e-7 and got[3] == 3
    # Wrong fingerprint -> None.
    assert load_state(ck, topology_fingerprint(np.arange(4))) is None
