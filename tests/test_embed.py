"""Embedding harness tests (the analog of the reference's wasm smoke test,
``ezpz-wasm/src/lib.rs`` + its JS driver)."""

import subprocess
import sys

import numpy as np

from ezpz_jax import embed


def test_hello():
    assert embed.hello() == 33


def test_linalg_probe():
    assert embed.test_linalg() == 1.0


def test_benchmark_solves_dependent_rectangles():
    vals = embed.benchmark()
    assert len(vals) == 14
    v = np.asarray(vals)
    # First rectangle: p0=(1,1), p1=(5,1), p2=(5,4), p3=(1,4).
    np.testing.assert_allclose(v[0:2], [1.0, 1.0], atol=1e-4)
    np.testing.assert_allclose(v[2:4], [5.0, 1.0], atol=1e-4)
    np.testing.assert_allclose(v[4:6], [5.0, 4.0], atol=1e-4)
    np.testing.assert_allclose(v[6:8], [1.0, 4.0], atol=1e-4)
    # Second rectangle hangs off p2 with 4x4 sides; its corners are
    # horizontally/vertically related to p2.
    assert abs(v[9] - v[5]) < 1e-4  # p5.y == p2.y (horizontal line1_bottom)
    assert abs(v[12] - v[4]) < 1e-4  # p7.x == p2.x (vertical line1_left)


def test_dbg_jac_prints_jacobian():
    """EZPZ_DBG_JAC=1 dumps the dense Jacobian each LM iteration
    (the reference's `dbg-jac` cargo feature, solver.rs:370-439)."""
    code = (
        "import os; os.environ['EZPZ_DBG_JAC'] = '1'\n"
        "import jax; jax.config.update('jax_platforms', 'cpu')\n"
        "import ezpz_jax as ez\n"
        "ids = ez.IdGenerator()\n"
        "p = ez.DatumPoint.new(ids); q = ez.DatumPoint.new(ids)\n"
        "reqs = [ez.ConstraintRequest.highest_priority(c) for c in [\n"
        "    ez.Constraint.Fixed(p.id_x(), 0.0),\n"
        "    ez.Constraint.Fixed(p.id_y(), 0.0),\n"
        "    ez.Constraint.Distance(p, q, 4.0)]]\n"
        "guesses = [(p.id_x(), 0.1), (p.id_y(), -0.02), (q.id_x(), 4.4), (q.id_y(), 1.0)]\n"
        "out = ez.solve(reqs, guesses, ez.Config())\n"
        "assert out.converged\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "dbg-jac: iteration" in proc.stdout + proc.stderr
