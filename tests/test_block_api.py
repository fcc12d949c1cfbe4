"""The public API's decomposed solve path (api._get_system_and_solver ->
models.blocks.BlockProgram).

Sketches with >= _DECOMPOSE_MIN independent components route through one
vmapped LM per topology bucket — the batched shape of the component
sparsity the reference's sparse-LLT Newton step (newton.rs:15) exploits
implicitly — returning the same packed outcome layout as the monolithic
jitted solver. These tests pin path selection, outcome equivalence, and
the per-constraint scatter of satisfaction/degeneracy."""

import numpy as np

import ezpz_jax as ez
from ezpz_jax.api import _get_system_and_solver
from ezpz_jax.config import Config
from ezpz_jax.models.blocks import BlockProgram
from ezpz_jax.models.compiled import CompiledSystem


def _fleet(K=12, inconsistent_at=None, degenerate_at=None):
    """K independent blocks of two alternating topologies (fixed point +
    distance; fixed segment via 4 Fixed). Optionally make one block
    unsatisfiable or degenerate."""
    ids = ez.IdGenerator()
    reqs, guesses = [], []
    for k in range(K):
        p, q = ez.DatumPoint.new(ids), ez.DatumPoint.new(ids)
        cs = [
            ez.Constraint.Fixed(p.id_x(), float(k)),
            ez.Constraint.Fixed(p.id_y(), 0.0),
            ez.Constraint.Distance(p, q, 2.0 + (k % 3)),
        ]
        if inconsistent_at == k:
            # Contradictory second distance on the same pair.
            cs.append(ez.Constraint.Distance(p, q, 100.0 + k))
        if degenerate_at == k:
            # Zero-length mirror line: k_symmetric flags degeneracy.
            a, b = ez.DatumPoint.new(ids), ez.DatumPoint.new(ids)
            seg = ez.DatumLineSegment(p, p)
            cs.append(ez.Constraint.Symmetric(seg, a, b))
            guesses += [(a.id_x(), 1.0), (a.id_y(), 0.5),
                        (b.id_x(), -1.0), (b.id_y(), 0.5)]
        reqs += [ez.ConstraintRequest.highest_priority(c) for c in cs]
        guesses += [
            (p.id_x(), float(k) + 0.1), (p.id_y(), -0.05),
            (q.id_x(), float(k) + 1.3), (q.id_y(), 1.1),
        ]
    guesses.sort(key=lambda g: g[0])
    return reqs, guesses


def test_path_selection_threshold(monkeypatch):
    """>= threshold components -> BlockProgram; below -> CompiledSystem."""
    reqs, guesses = _fleet(K=12)
    constraints = [r.constraint for r in reqs]
    weights = [1.0] * len(constraints)

    monkeypatch.setenv("EZPZ_DECOMPOSE_MIN", "8")
    system, _ = _get_system_and_solver(constraints, weights, len(guesses), 50)
    assert isinstance(system, BlockProgram)
    assert system.n_components == 12

    monkeypatch.setenv("EZPZ_DECOMPOSE_MIN", "13")
    system, _ = _get_system_and_solver(constraints, weights, len(guesses), 50)
    assert isinstance(system, CompiledSystem)

    monkeypatch.setenv("EZPZ_DECOMPOSE_MIN", "0")
    system, _ = _get_system_and_solver(constraints, weights, len(guesses), 50)
    assert isinstance(system, CompiledSystem)


def test_block_path_matches_monolithic(monkeypatch):
    """Full public-API equivalence on a decomposable sketch: same
    convergence, same satisfied set, coordinates within the corpus
    tolerance, identical freedom analysis."""
    reqs, guesses = _fleet(K=12)

    monkeypatch.setenv("EZPZ_DECOMPOSE_MIN", "0")
    mono = ez.solve_analysis(reqs, guesses)
    monkeypatch.setenv("EZPZ_DECOMPOSE_MIN", "8")
    blk = ez.solve_analysis(reqs, guesses)

    assert blk.outcome.converged and mono.outcome.converged
    assert blk.outcome.unsatisfied == mono.outcome.unsatisfied == []
    np.testing.assert_allclose(
        np.asarray(blk.outcome.final_values),
        np.asarray(mono.outcome.final_values),
        atol=1e-6,
    )
    assert (blk.analysis.underconstrained()
            == mono.analysis.underconstrained())


def test_block_path_scatters_unsatisfied_to_the_right_block(monkeypatch):
    """One unsatisfiable block: exactly its contradictory pair is reported
    unsatisfied, every other block's constraints stay satisfied — the
    cid_index scatter, not just an all-reduce."""
    monkeypatch.setenv("EZPZ_DECOMPOSE_MIN", "8")
    reqs, guesses = _fleet(K=12, inconsistent_at=5)
    out = ez.solve(reqs, guesses)
    # Block 5 carries 4 requests: indices 15..18 (3 per earlier block).
    bad = [cid for cid in out.unsatisfied]
    assert bad, "contradictory distances cannot both be satisfied"
    assert set(bad) <= {15, 16, 17, 18}
    # And specifically the two distance rows disagree, not the Fixed pins.
    assert 17 in bad or 18 in bad


def test_block_path_scatters_degenerate_warning(monkeypatch):
    """A zero-length mirror line in one block produces that block's
    DEGENERATE warning through the decomposed path."""
    from ezpz_jax.utils.warnings import WarningKind

    monkeypatch.setenv("EZPZ_DECOMPOSE_MIN", "8")
    reqs, guesses = _fleet(K=12, degenerate_at=3)
    out = ez.solve(reqs, guesses)
    flagged = [w.about_constraint for w in out.warnings
               if w.content == WarningKind.DEGENERATE]
    # Block 3's Symmetric request is index 12 (3 requests per block before).
    assert flagged == [12]


def test_block_path_keeps_unreferenced_guesses(monkeypatch):
    """A guessed-but-unconstrained variable passes through both paths at
    its initial value."""
    reqs, guesses = _fleet(K=10)
    # Append one free variable at the end of the id space.
    free_id = len(guesses)
    guesses = guesses + [(free_id, 7.25)]
    for env in ("0", "4"):
        import os
        os.environ["EZPZ_DECOMPOSE_MIN"] = env
        try:
            out = ez.solve(reqs, guesses)
            assert out.final_values[free_id] == 7.25
        finally:
            os.environ.pop("EZPZ_DECOMPOSE_MIN", None)


def test_block_analysis_matches_monolithic_global_tolerances(monkeypatch):
    """The decomposed freedom analysis must keep the reference's GLOBAL
    thresholds: a block whose requests carry weight 1e-12 is globally
    rank-deficient (its rows fall under 1e-8 * the global largest singular
    value) even though per-block tolerances would call it full-rank; and a
    guessed-but-unconstrained variable (zero column -> participation
    exactly 1) is underconstrained. Both paths must agree exactly."""
    ids = ez.IdGenerator()
    reqs, guesses = [], []
    for k in range(10):
        p, q = ez.DatumPoint.new(ids), ez.DatumPoint.new(ids)
        w = 1e-12 if k == 4 else 1.0
        for c in [ez.Constraint.Fixed(p.id_x(), float(k)),
                  ez.Constraint.Fixed(p.id_y(), 0.0),
                  ez.Constraint.Fixed(q.id_x(), float(k) + 1.0),
                  ez.Constraint.Fixed(q.id_y(), 1.0)]:
            reqs.append(ez.ConstraintRequest(constraint=c, priority=0, weight=w))
        guesses += [(p.id_x(), float(k)), (p.id_y(), 0.0),
                    (q.id_x(), float(k) + 1.0), (q.id_y(), 1.0)]
    free_id = len(guesses)
    guesses.append((free_id, 3.5))

    monkeypatch.setenv("EZPZ_DECOMPOSE_MIN", "0")
    mono = ez.solve_analysis(reqs, guesses)
    monkeypatch.setenv("EZPZ_DECOMPOSE_MIN", "4")
    blk = ez.solve_analysis(reqs, guesses)

    assert blk.analysis.underconstrained() == mono.analysis.underconstrained()
    under = set(blk.analysis.underconstrained())
    # The weight-1e-12 block's four variables (ids 16..19) and the free
    # variable are the underconstrained set.
    assert under == {16, 17, 18, 19, free_id}


def test_block_path_mixed_precision(monkeypatch):
    """precision="mixed" through the decomposed path: per-bucket
    solve_lm_mixed with cast parameters. Fully-constrained blocks (the
    _fleet blocks leave q on a circle, where the two precisions
    legitimately pick different points) so the solutions are unique and
    must coincide."""
    monkeypatch.setenv("EZPZ_DECOMPOSE_MIN", "8")
    ids = ez.IdGenerator()
    reqs, guesses = [], []
    for k in range(12):
        p, q = ez.DatumPoint.new(ids), ez.DatumPoint.new(ids)
        for c in [ez.Constraint.Fixed(p.id_x(), float(k)),
                  ez.Constraint.Fixed(p.id_y(), 0.0),
                  ez.Constraint.Fixed(q.id_x(), float(k) + 3.0),
                  ez.Constraint.Distance(p, q, 5.0)]:
            reqs.append(ez.ConstraintRequest.highest_priority(c))
        guesses += [(p.id_x(), k + 0.1), (p.id_y(), -0.05),
                    (q.id_x(), k + 3.2), (q.id_y(), 3.7)]
    f64 = ez.solve(reqs, guesses)
    mixed = ez.solve(reqs, guesses, Config().with_precision("mixed"))
    assert mixed.converged
    assert mixed.unsatisfied == []
    np.testing.assert_allclose(np.asarray(mixed.final_values),
                               np.asarray(f64.final_values), atol=1e-6)


def test_decompose_threshold_default_and_equality(monkeypatch):
    """Without any env override, the documented default threshold (32)
    applies, and the comparisons are INCLUSIVE: a sketch with exactly 32
    single-constraint components decomposes (mutation-found: the default
    constant and all three >= comparisons along the gate)."""
    import ezpz_jax.api as api

    monkeypatch.delenv("EZPZ_DECOMPOSE_MIN", raising=False)
    assert api._DECOMPOSE_MIN_DEFAULT == 32
    constraints = [ez.Constraint.Fixed(i, float(i)) for i in range(32)]
    weights = [1.0] * 32
    system, _ = _get_system_and_solver(constraints, weights, 32, 50)
    assert isinstance(system, BlockProgram)
    assert system.n_components == 32
    # 31 components stays monolithic under the default.
    system31, _ = _get_system_and_solver(constraints[:31], weights[:31], 31, 50)
    assert isinstance(system31, CompiledSystem)


def test_solver_cache_respects_limit(monkeypatch):
    """The LRU eviction keeps the cache AT the limit, not one past it
    (mutation-found off-by-one in the eviction comparison)."""
    import ezpz_jax.api as api

    assert api._SOLVER_CACHE_LIMIT == 256  # the documented working-set size
    monkeypatch.setattr(api, "_SOLVER_CACHE_LIMIT", 3)
    api._SOLVER_CACHE.clear()
    for k in range(4):
        c = [ez.Constraint.Fixed(0, float(k + 1))]
        api._get_system_and_solver(c, [1.0], 1, 50)
    assert len(api._SOLVER_CACHE) <= 3
    api._SOLVER_CACHE.clear()
