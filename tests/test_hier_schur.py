"""ShardedBlockSchurSolver: two-level (batched-interior, sharded-part)
Schur solve on the virtual 8-device mesh (``parallel/hier.py``)."""

import numpy as np
import pytest

import jax

import ezpz_jax  # noqa: F401
from ezpz_jax.constraints import Constraint
from ezpz_jax.datatypes import DatumPoint
from ezpz_jax.parallel import BlockSchurSolver, ShardedBlockSchurSolver


def _need_devices(n=8):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} devices")


def _coupled_chain(lines):
    """The gen_massive coupled chain, built through the textual path."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
    from gen_massive import generate_coupled

    from ezpz_jax.textual import Problem

    cs = Problem.from_str(generate_coupled(lines)).to_constraint_system()
    constraints = [r.constraint for r in cs.constraints]
    x0 = np.zeros(len(cs.initial_guesses))
    for vid, val in cs.initial_guesses:
        x0[vid] = val
    return constraints, x0


def _hub(lines, cluster=10):
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
    from gen_massive import generate_coupled_hub

    from ezpz_jax.textual import Problem

    cs = Problem.from_str(
        generate_coupled_hub(lines, cluster)).to_constraint_system()
    constraints = [r.constraint for r in cs.constraints]
    x0 = np.zeros(len(cs.initial_guesses))
    for vid, val in cs.initial_guesses:
        x0[vid] = val
    line_of = np.arange(len(x0)) // 4
    part_of_var = np.where(line_of == 0, 0, 1 + (line_of - 1) // cluster)
    return constraints, x0, part_of_var


def test_dense_matches_block_schur():
    """boundary_solver='dense' on the mesh runs BlockSchurSolver's math
    with a psum'd Schur assembly: identical iteration counts, solutions
    equal up to the f32 reduction-order noise of summing 8 partial Schur
    contributions instead of one scatter-add (~1e-9)."""
    _need_devices()
    constraints, x0 = _coupled_chain(60)
    n = len(x0)
    ref = BlockSchurSolver(constraints, n, precision="mixed").solve(x0)
    out = ShardedBlockSchurSolver(
        constraints, n, precision="mixed", boundary_solver="dense").solve(x0)
    assert out["converged"] and ref["converged"]
    assert out["iterations"] == ref["iterations"]
    np.testing.assert_allclose(out["x"], ref["x"], rtol=0, atol=1e-7)
    np.testing.assert_array_equal(out["satisfied"], ref["satisfied"])


def test_cg_converges_to_f64_tolerance():
    """The distributed Jacobi-PCG boundary path reaches the 1e-8 f64
    residual despite inexact (f32, truncated-CG) steps."""
    _need_devices()
    constraints, x0 = _coupled_chain(60)
    n = len(x0)
    out = ShardedBlockSchurSolver(
        constraints, n, precision="mixed", boundary_solver="cg").solve(x0)
    assert out["converged"]
    assert out["residual_inf"] <= 1e-8
    assert out["satisfied"].all()
    assert out["n_boundary"] > 0


def test_hub_topology_explicit_partition():
    """Hub-coupled assembly with an explicit part_of_var: clusters stay
    interior, only hub + cluster-head lines are boundary."""
    _need_devices()
    constraints, x0, pov = _hub(51, cluster=5)
    n = len(x0)
    out = ShardedBlockSchurSolver(
        constraints, n, precision="mixed", boundary_solver="cg",
        part_of_var=pov).solve(x0)
    assert out["converged"]
    assert out["residual_inf"] <= 1e-8
    assert out["satisfied"].all()
    # boundary = hub line + one line per cluster, 4 vars each
    assert out["n_boundary"] == 4 + 4 * 10


def test_f64_precision_path():
    _need_devices()
    constraints, x0 = _coupled_chain(24)
    n = len(x0)
    out = ShardedBlockSchurSolver(
        constraints, n, precision="f64", boundary_solver="cg").solve(x0)
    assert out["converged"]
    assert out["residual_inf"] <= 1e-8


def test_degenerate_flags_propagate():
    """A degenerate constraint (coincident distance endpoints) on one part
    must flag through the psum'd degeneracy reduction."""
    _need_devices()
    p0, p1, p2, p3 = (DatumPoint(2 * i, 2 * i + 1) for i in range(4))
    cs = [
        Constraint.Fixed(0, 0.0), Constraint.Fixed(1, 0.0),
        Constraint.Distance(p0, p1, 2.0),
        Constraint.Fixed(4, 1.0), Constraint.Fixed(5, 0.0),
        Constraint.Distance(p2, p3, 2.0),
        Constraint.ScalarEqual(3, 7),
    ]
    x0 = np.array([0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 2.4, 1.6])  # p1 == p0
    out = ShardedBlockSchurSolver(cs, 8, n_parts=2).solve(x0)
    assert bool(out["degenerate"][2])


def test_banded_boundary_matches_cg():
    """boundary_solver='banded' (exact block-tridiagonal direct solve,
    one band psum per LM iteration) agrees with the CG and dense paths on
    the sharded coupled chain, with the chain's constant half-bandwidth."""
    _need_devices()
    constraints, x0 = _coupled_chain(24)
    n = len(x0)
    ref = ShardedBlockSchurSolver(
        constraints, n, n_parts=8, precision="mixed",
        boundary_solver="dense").solve(x0)
    solver = ShardedBlockSchurSolver(
        constraints, n, n_parts=8, precision="mixed",
        boundary_solver="banded")
    out = solver.solve(x0)
    assert out["converged"] and ref["converged"]
    # Exact steps: iteration count matches the dense (exact) path.
    assert out["iterations"] == ref["iterations"]
    assert out["satisfied"].all()
    np.testing.assert_allclose(out["x"], ref["x"], rtol=0, atol=1e-6)
    assert 0 < solver.band_bw < solver.n_b


def test_auto_boundary_resolves_structurally():
    """boundary_solver='auto' on the mesh: a long chain resolves to
    'banded' (thin band), a hub topology to 'dense'/'cg' by boundary
    size — and the resolved solver still converges."""
    _need_devices()
    constraints, x0 = _coupled_chain(24)
    s = ShardedBlockSchurSolver(constraints, len(x0), n_parts=8,
                                precision="mixed", boundary_solver="auto")
    assert s.boundary_solver == "banded", (s.boundary_solver, s.band_bw, s.n_b)
    out = s.solve(x0)
    assert out["converged"] and out["satisfied"].all()

    hub_cs, hub_x0, pov = _hub(17, cluster=4)
    h = ShardedBlockSchurSolver(hub_cs, len(hub_x0), part_of_var=pov,
                                precision="mixed", boundary_solver="auto")
    # Hub: every part shares the hub line's variables -> fat band -> not
    # banded; small boundary -> dense.
    assert h.boundary_solver in ("dense", "cg")
    assert h.boundary_solver == ("dense" if h.n_b <= 256 else "cg")
