"""Batched device-side freedom (DoF) analysis: one vmapped SVD pass for a
whole fleet must equal a loop of the reference-parity host analyses
(``ezpz/src/solver/find_dof.rs:15-104``).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from ezpz_jax.batch import BatchSolver
from ezpz_jax.config import Config
from ezpz_jax.constraints import Constraint
from ezpz_jax.datatypes import DatumPoint
from ezpz_jax.dof import freedom_analysis, freedom_analysis_batch
from ezpz_jax.models.compiled import compile_system
from ezpz_jax.utils.errors import EmptySystemNotAllowed


def _underconstrained_system():
    """p free along a distance circle around fixed q: 2 underconstrained
    vars (the analog of the `underconstrained` golden fixture)."""
    p = DatumPoint(0, 1)
    q = DatumPoint(2, 3)
    cs = [
        Constraint.Fixed(q.x_id, 0.0),
        Constraint.Fixed(q.y_id, 0.0),
        Constraint.Distance(p, q, jnp.sqrt(2.0)),
    ]
    return compile_system(cs, 4)


def _well_constrained_system():
    p = DatumPoint(0, 1)
    q = DatumPoint(2, 3)
    cs = [
        Constraint.Fixed(p.x_id, 0.0),
        Constraint.Fixed(p.y_id, 0.0),
        Constraint.Fixed(q.x_id, 3.0),
        Constraint.Distance(p, q, 5.0),
    ]
    return compile_system(cs, 4)


def test_batch_matches_host_loop_underconstrained():
    system = _underconstrained_system()
    solver = BatchSolver(system, Config())
    rng = np.random.default_rng(0)
    B = 16
    x0 = np.zeros((B, 4))
    x0[:, 0] = rng.uniform(0.5, 2.0, B)
    x0[:, 1] = rng.uniform(0.5, 2.0, B)
    res, analyses = solver.solve_analysis(jnp.asarray(x0))
    assert bool(np.asarray(res.converged).all())
    assert len(analyses) == B
    for i in range(B):
        # Host reference on the same solved point.
        j = np.asarray(system.jacobian_dense(jnp.asarray(res.x)[i]))
        host = freedom_analysis(j)
        assert analyses[i].underconstrained() == host.underconstrained(), i
        assert analyses[i].is_underconstrained()
        assert analyses[i].underconstrained() == [0, 1]


def test_batch_matches_host_loop_well_constrained():
    system = _well_constrained_system()
    solver = BatchSolver(system, Config())
    x0 = np.zeros((8, 4))
    x0[:, 2] = 3.0 + np.arange(8) * 0.1
    x0[:, 3] = 3.5
    res, analyses = solver.solve_analysis(jnp.asarray(x0))
    assert bool(np.asarray(res.converged).all())
    for a in analyses:
        assert not a.is_underconstrained()


def test_freedom_analysis_batch_standalone():
    """freedom_analysis_batch(j_batch) == [freedom_analysis(j) for j] on
    random rank-deficient Jacobians."""
    rng = np.random.default_rng(7)
    B, m, n = 6, 5, 7
    base = rng.standard_normal((B, m, n))
    # Force rank deficiency beyond the m<n structural one: zero a column.
    base[:, :, 4] = 0.0
    batch = freedom_analysis_batch(base)
    for i in range(B):
        host = freedom_analysis(base[i])
        assert batch[i].underconstrained() == host.underconstrained(), i


def test_batch_dof_mixed_precision_path():
    """solve_analysis composes with the mixed-precision solver (analysis
    always runs on the f64 Jacobian at the refined solution)."""
    system = _well_constrained_system()
    solver = BatchSolver(system, Config(), precision="mixed")
    x0 = np.zeros((4, 4))
    x0[:, 2] = 3.2
    x0[:, 3] = 3.9
    res, analyses = solver.solve_analysis(jnp.asarray(x0))
    assert bool(np.asarray(res.converged).all())
    assert all(not a.is_underconstrained() for a in analyses)


def test_empty_jacobian_raises():
    with pytest.raises(EmptySystemNotAllowed):
        freedom_analysis_batch(np.zeros((2, 0, 4)))


def test_dof_rank_tolerance_decade_and_relative():
    """The rank cut is 1e-8 * the LARGEST singular value (find_dof.rs:12,
    40-47): a 3e-8 singular value survives at scale 1 (decade pin), a 3e-9
    one does not, and at scale 100 an absolute 1e-8 direction is
    rank-deficient (relative, not absolute — mutation-found)."""
    from ezpz_jax.dof import freedom_analysis

    assert freedom_analysis(np.diag([1.0, 3e-8])).underconstrained() == []
    assert freedom_analysis(np.diag([1.0, 3e-9])).underconstrained() == [1]
    assert freedom_analysis(np.diag([100.0, 1e-8])).underconstrained() == [1]
    # Same relative-tolerance semantics through the batched device path.
    from ezpz_jax.dof import freedom_analysis_batch

    assert [a.underconstrained() for a in
            freedom_analysis_batch(np.diag([100.0, 1e-8])[None])] == [[1]]


def test_dof_participation_window_both_paths():
    """The participation cut is 1e-3 * the max participation
    (find_dof.rs:81-104): a variable entering the nullspace with relative
    magnitude 3e-3 is underconstrained, at 3e-4 it is not — through BOTH
    the host path and the batched device path (mutation-found decade)."""
    from ezpz_jax.dof import freedom_analysis, freedom_analysis_batch

    row_in = np.asarray([[1.0, 3e-3, 0.0]])
    row_out = np.asarray([[1.0, 3e-4, 0.0]])
    assert freedom_analysis(row_in).underconstrained() == [0, 1, 2]
    assert freedom_analysis(row_out).underconstrained() == [1, 2]
    assert [a.underconstrained() for a in
            freedom_analysis_batch(row_in[None])] == [[0, 1, 2]]
    assert [a.underconstrained() for a in
            freedom_analysis_batch(row_out[None])] == [[1, 2]]


def test_dof_participation_tolerance_is_relative():
    """The participation cut scales with the max participation, which is
    1/3 (not 1) for a nullspace direction spread over a 3-variable chain:
    a fourth variable coupled at relative 1.7e-3 must still be listed
    (an inverted scaling, 1e-3 / max, would cut it — mutation-found)."""
    from ezpz_jax.dof import freedom_analysis

    eps = 1.7e-3
    j = np.asarray([
        [1.0, -1.0, 0.0, 0.0],
        [0.0, 1.0, -1.0, 0.0],
        [eps, 0.0, 0.0, 1.0],
    ])
    assert freedom_analysis(j).underconstrained() == [0, 1, 2, 3]


def test_dof_zero_jacobian_fully_free_both_paths():
    """An all-zero Jacobian (every constraint disabled, e.g. weight 0)
    leaves every variable underconstrained. Pins the strict/inclusive
    orientation of the rank comparisons at sigma == tol == 0 exactly
    (mutation-found: host `s > tol` and device `s_pad <= tol`)."""
    from ezpz_jax.dof import freedom_analysis, freedom_analysis_batch

    assert freedom_analysis(np.zeros((2, 3))).underconstrained() == [0, 1, 2]
    assert [a.underconstrained() for a in
            freedom_analysis_batch(np.zeros((1, 2, 3)))] == [[0, 1, 2]]
