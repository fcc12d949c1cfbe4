"""BlockSchurSolver: single-device partitioned Schur solves for *coupled*
systems (the batched answer to the reference's sparse LLT on one core,
``ezpz/src/solver/newton.rs:87-102``). Correctness = exact agreement with
the global dense solve_lm path on the same constraints.
"""

import numpy as np
import pytest

import jax.numpy as jnp

import ezpz_jax as ez
from ezpz_jax.config import Config
from ezpz_jax.constraints import Constraint
from ezpz_jax.datatypes import DatumPoint
from ezpz_jax.models.compiled import compile_system
from ezpz_jax.parallel import BlockSchurSolver
from ezpz_jax.solver import solve_lm

from .test_parallel import _coupled_chain_problem


def _global(constraints, x0):
    c = Config()
    system = compile_system(constraints, len(x0))
    return solve_lm(system, jnp.asarray(x0), c.max_iterations,
                    c.residual_tolerance, c.step_tolerance, c.initial_lambda)


def test_f64_matches_global_solve():
    """f64 partitioned-Schur: identical x AND identical iteration count to
    the global dense path (same LM loop, exact same step in exact
    arithmetic)."""
    constraints, x0 = _coupled_chain_problem(n_blocks=8, pts_per_block=4)
    ref = _global(constraints, x0)
    out = BlockSchurSolver(constraints, len(x0), precision="f64").solve(x0)
    assert out["converged"]
    assert out["n_boundary"] > 0  # genuinely coupled
    assert out["n_parts"] > 1
    assert out["iterations"] == int(ref.iterations)
    np.testing.assert_allclose(out["x"], np.asarray(ref.x), atol=1e-9)
    assert bool(np.asarray(out["satisfied"]).all())


def test_mixed_precision_converges_to_f64_answer():
    constraints, x0 = _coupled_chain_problem(n_blocks=8, pts_per_block=4)
    ref = _global(constraints, x0)
    out = BlockSchurSolver(constraints, len(x0), precision="mixed").solve(x0)
    assert out["converged"]
    # f32 steps, f64 accept/reject: same solution to well below the 1e-4
    # satisfaction epsilon (typically ~1e-7).
    np.testing.assert_allclose(out["x"], np.asarray(ref.x), atol=1e-5)
    assert bool(np.asarray(out["satisfied"]).all())


def test_explicit_partition_count():
    """More partitions (smaller interiors, bigger boundary) must not change
    the answer."""
    constraints, x0 = _coupled_chain_problem(n_blocks=8, pts_per_block=4)
    ref = _global(constraints, x0)
    for P in (1, 4, 8):
        out = BlockSchurSolver(
            constraints, len(x0), n_parts=P, precision="f64"
        ).solve(x0)
        assert out["converged"], P
        np.testing.assert_allclose(out["x"], np.asarray(ref.x), atol=1e-9,
                                   err_msg=f"P={P}")


def test_batch_matches_loop_of_singles():
    """solve_batch over perturbed guesses == per-guess solve (vmap
    equivalence, the framework-wide batching invariant)."""
    constraints, x0 = _coupled_chain_problem(n_blocks=4, pts_per_block=3)
    s = BlockSchurSolver(constraints, len(x0), precision="f64")
    rng = np.random.default_rng(1)
    x0s = np.stack([x0 + rng.uniform(-0.05, 0.05, len(x0)) for _ in range(4)])
    res, sat = s.solve_batch(x0s)
    assert bool(np.asarray(res.converged).all())
    assert bool(np.asarray(sat).all())
    for i in range(4):
        single = s.solve(x0s[i])
        assert single["iterations"] == int(np.asarray(res.iterations)[i])
        np.testing.assert_allclose(np.asarray(res.x)[i], single["x"], atol=1e-12)


def test_uncoupled_system_has_empty_boundary():
    """A block-diagonal problem partitions with n_boundary == 0 and still
    solves (pure batched-interior path)."""
    cs = []
    x0 = np.zeros(8)
    for b in range(2):
        p = DatumPoint(4 * b, 4 * b + 1)
        q = DatumPoint(4 * b + 2, 4 * b + 3)
        cs += [Constraint.Fixed(p.x_id, 0.0), Constraint.Fixed(p.y_id, 0.0),
               Constraint.Distance(p, q, 5.0)]
        x0[4 * b + 2] = 3.0 + b
        x0[4 * b + 3] = 3.0
    out = BlockSchurSolver(cs, 8, n_parts=2, precision="f64").solve(x0)
    assert out["n_boundary"] == 0
    assert out["converged"]
    ref = _global(cs, x0)
    np.testing.assert_allclose(out["x"], np.asarray(ref.x), atol=1e-9)


def test_textual_coupled_fixture():
    """End to end through the textual frontend on the coupled generator
    (tools/gen_massive.py) — the non-block-diagonal massive variant."""
    import subprocess
    import sys as _sys
    import os
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    txt = subprocess.run(
        [_sys.executable, os.path.join(here, "tools", "gen_massive.py"),
         "12", "coupled"],
        capture_output=True, text=True, check=True).stdout
    from ezpz_jax.textual import Problem
    cs = Problem.from_str(txt).to_constraint_system()
    constraints = [r.constraint for r in cs.constraints]
    x0 = np.zeros(len(cs.initial_guesses))
    for vid, val in cs.initial_guesses:
        x0[vid] = val
    ref = _global(constraints, x0)
    assert bool(ref.converged)
    out = BlockSchurSolver(constraints, len(x0), precision="f64").solve(x0)
    assert out["converged"]
    assert out["n_boundary"] > 0
    np.testing.assert_allclose(out["x"], np.asarray(ref.x), atol=1e-8)


def test_explicit_n_parts_is_honored():
    """An explicit n_parts must be used verbatim — the default heuristic
    (ceil(n_vars/40)) only applies when BOTH n_parts and part_of_var are
    None (mutation-found: flipping that `and` to `or` silently recomputed
    a caller's n_parts)."""
    constraints, x0 = _coupled_chain_problem(12)
    for n_parts in (2, 5):
        s = BlockSchurSolver(constraints, len(x0), n_parts=n_parts,
                             precision="f64")
        assert s.P == n_parts
    # and the default still kicks in when neither is given
    s = BlockSchurSolver(constraints, len(x0), precision="f64")
    assert s.P == max(1, int(np.ceil(len(x0) / 40)))


def test_cg_boundary_matches_dense():
    """boundary_solver='cg' (Jacobi-PCG, Schur matrix never materialized)
    converges to the same solution and iteration count as the dense
    boundary Cholesky on the coupled chain."""
    import subprocess
    import sys as _sys
    import os
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    txt = subprocess.run(
        [_sys.executable, os.path.join(here, "tools", "gen_massive.py"),
         "24", "coupled"],
        capture_output=True, text=True, check=True).stdout
    from ezpz_jax.textual import Problem
    cs = Problem.from_str(txt).to_constraint_system()
    constraints = [r.constraint for r in cs.constraints]
    x0 = np.zeros(len(cs.initial_guesses))
    for vid, val in cs.initial_guesses:
        x0[vid] = val
    n = len(x0)
    ref = BlockSchurSolver(constraints, n, precision="mixed").solve(x0)
    out = BlockSchurSolver(constraints, n, precision="mixed",
                           boundary_solver="cg").solve(x0)
    assert out["converged"] and ref["converged"]
    assert out["iterations"] == ref["iterations"]
    assert out["n_boundary"] == ref["n_boundary"] > 0
    np.testing.assert_allclose(out["x"], ref["x"], rtol=0, atol=1e-7)
    assert out["satisfied"].all()


def test_banded_boundary_matches_dense():
    """boundary_solver='banded' (exact lower-band direct solve,
    ops/banded.py) reproduces the dense boundary Cholesky BITWISE-closely
    on the coupled chain: same iteration count, same solution, and a
    half-bandwidth that stays at the interface width (constant in
    n_parts) while n_b grows — the O(n_b * bw^2) vs O(n_b^3) claim."""
    import subprocess
    import sys as _sys
    import os
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    txt = subprocess.run(
        [_sys.executable, os.path.join(here, "tools", "gen_massive.py"),
         "24", "coupled"],
        capture_output=True, text=True, check=True).stdout
    from ezpz_jax.textual import Problem
    cs = Problem.from_str(txt).to_constraint_system()
    constraints = [r.constraint for r in cs.constraints]
    x0 = np.zeros(len(cs.initial_guesses))
    for vid, val in cs.initial_guesses:
        x0[vid] = val
    n = len(x0)
    bws = {}
    for n_parts in (4, 8):
        ref = BlockSchurSolver(constraints, n, n_parts=n_parts,
                               precision="mixed").solve(x0)
        solver = BlockSchurSolver(constraints, n, n_parts=n_parts,
                                  precision="mixed",
                                  boundary_solver="banded")
        out = solver.solve(x0)
        assert out["converged"] and ref["converged"]
        assert out["iterations"] == ref["iterations"]
        assert out["n_boundary"] == ref["n_boundary"] > 0
        np.testing.assert_allclose(out["x"], ref["x"], rtol=0, atol=1e-7)
        assert out["satisfied"].all()
        bws[n_parts] = solver.band_bw
    # Chain structure: bandwidth is set by the interface width, not n_b.
    assert bws[8] == bws[4]


def test_banded_ops_against_dense():
    """ops/banded.py factor+solve agrees with a dense solve on random SPD
    banded matrices, flags non-SPD input, and batches under vmap."""
    import jax
    from ezpz_jax.ops.banded import banded_spd_solve, dense_to_band

    rng = np.random.default_rng(7)
    for n, bw in [(9, 0), (13, 2), (33, 6)]:
        A = np.zeros((n, n))
        for i in range(n):
            for j in range(max(0, i - bw), i + 1):
                A[i, j] = A[j, i] = rng.normal()
        A += np.eye(n) * (2 * bw + 5)
        b = rng.normal(size=(n,))
        x, fail = banded_spd_solve(dense_to_band(jnp.asarray(A), bw),
                                   jnp.asarray(b))
        assert not bool(fail)
        np.testing.assert_allclose(np.asarray(x), np.linalg.solve(A, b),
                                   atol=1e-10)
    # Non-SPD: fail flag + zero-filled solution (spd_solve contract).
    A2 = np.eye(6)
    A2[2, 2] = -1.0
    x, fail = banded_spd_solve(dense_to_band(jnp.asarray(A2), 1),
                               jnp.asarray(rng.normal(size=6)))
    assert bool(fail) and np.allclose(np.asarray(x), 0.0)
    # vmap over a batch axis.
    A = np.zeros((12, 12))
    for i in range(12):
        for j in range(max(0, i - 3), i + 1):
            A[i, j] = A[j, i] = rng.normal()
    A += np.eye(12) * 11
    Ab = dense_to_band(jnp.asarray(A), 3)
    B = rng.normal(size=(4, 12))
    xs, fails = jax.vmap(banded_spd_solve, in_axes=(None, 0))(Ab, jnp.asarray(B))
    assert not bool(np.asarray(fails).any())
    for k in range(4):
        np.testing.assert_allclose(np.asarray(xs[k]),
                                   np.linalg.solve(A, B[k]), atol=1e-10)


def test_banded_exactly_singular_pivot_flags_failure():
    """An EXACTLY-zero Cholesky pivot must set the fail flag (the strict
    ``diag2 > 0`` pivot check in ``banded_cholesky`` — the boundary the
    non-SPD test above never hits because its pivot goes negative, not
    zero). A = [[1,1],[1,1]] factors to diag2 = 1 - 1^2 = 0.0 exactly
    in f64; an inclusive comparison would accept the zero pivot, divide
    by it in the substitution sweeps, and hand the LM loop inf/NaN with
    fail=False — defeating the failure->re-damp semantics (the
    reference's numeric-LLT-failure->raise-lambda branch in its LM
    loop). Kills the Gt->GtE mutant on that pivot check."""
    from ezpz_jax.ops.banded import banded_spd_solve, dense_to_band

    A = np.ones((2, 2))
    x, fail = banded_spd_solve(dense_to_band(jnp.asarray(A), 1),
                               jnp.asarray([1.0, 2.0]))
    assert bool(fail) and np.allclose(np.asarray(x), 0.0)
    # Same boundary mid-matrix: a 4x4 whose third pivot cancels exactly.
    A4 = np.eye(4)
    A4[1, 2] = A4[2, 1] = 1.0  # rank-deficient 2x2 block [[1,1],[1,1]]
    A4[2, 2] = 1.0
    x4, fail4 = banded_spd_solve(dense_to_band(jnp.asarray(A4), 1),
                                 jnp.asarray(np.ones(4)))
    assert bool(fail4) and np.allclose(np.asarray(x4), 0.0)


def test_mixed_precision_uses_f32_jacobian_system():
    """The mixed-precision contract: precision='mixed' must lower the
    Jacobian-side system to float32 (the whole point of the mode);
    precision='f64' must not. Kills the system_j dtype-selection mutant."""
    constraints, x0 = _coupled_chain_problem()
    mix = BlockSchurSolver(constraints, len(x0), n_parts=4, precision="mixed")
    f64 = BlockSchurSolver(constraints, len(x0), n_parts=4, precision="f64")
    assert mix.jac_dtype == jnp.float32
    assert any(
        np.asarray(b.par).dtype == np.float32 for b in mix.system_j.blocks
    ) or mix.system_j is not mix.system
    assert f64.system_j is f64.system


def test_interiors_partition_not_replicate():
    """Interior variable lists must PARTITION the non-boundary variables:
    each part's padded interior width m stays near n_vars/n_parts. A
    membership bug that replicates global interiors into every part still
    solves correctly (untouched vars get zero steps) but blows the padded
    width to ~n_vars — a silent quadratic cost. Pin the structure."""
    constraints, x0 = _coupled_chain_problem()
    n_vars = len(x0)
    n_parts = 8
    solver = BlockSchurSolver(constraints, n_vars, n_parts=n_parts)
    assert solver.m <= (n_vars + n_parts - 1) // n_parts + solver.kb


def test_weight_zero_degeneracy_matches_main_path():
    """Framework-wide degeneracy contract: a geometrically degenerate
    constraint is flagged even at weight 0 (the reference evaluates every
    constraint regardless of weight; residual_and_flags does too).
    BlockSchurSolver must agree with the global path, and flag ONLY the
    genuinely degenerate constraint — a padded lane must never leak a flag
    onto a healthy constraint (padded lanes route to the dummy cid slot)."""
    p0, p1, p2, p3 = (DatumPoint(2 * i, 2 * i + 1) for i in range(4))
    cs = [
        Constraint.Fixed(0, 0.0), Constraint.Fixed(1, 0.0),
        Constraint.Distance(p0, p1, 2.0),
        Constraint.Fixed(4, 1.0), Constraint.Fixed(5, 0.0),
        Constraint.Distance(p2, p3, 2.0),
        Constraint.ScalarEqual(3, 7),
    ]
    # p1 == p0: the FIRST distance starts geometrically degenerate and is
    # weighted 0, so the solver never moves it off the singularity.
    weights = [1.0, 1.0, 0.0, 1.0, 1.0, 1.0, 1.0]
    x0 = np.array([0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 2.4, 1.6])
    out = BlockSchurSolver(cs, 8, n_parts=2, weights=weights).solve(x0)
    c = Config()
    ref = solve_lm(
        compile_system(cs, 8, weights), jnp.asarray(x0), c.max_iterations,
        c.residual_tolerance, c.step_tolerance, c.initial_lambda,
    )
    np.testing.assert_array_equal(
        np.asarray(out["degenerate"]), np.asarray(ref.deg))
    assert bool(out["degenerate"][2])          # the disabled-but-degenerate one
    assert not np.asarray(out["degenerate"])[[0, 1, 3, 4, 5, 6]].any()


def test_cg_defaults_pinned():
    """The documented CG-boundary defaults (docstring of __init__): 1e-5
    relative tolerance for f32 linear algebra, 1e-12 for f64, 400 max
    iterations. Kills the constant/branch mutants on those defaults."""
    constraints, x0 = _coupled_chain_problem()
    mix = BlockSchurSolver(constraints, len(x0), n_parts=4,
                           precision="mixed", boundary_solver="cg")
    f64 = BlockSchurSolver(constraints, len(x0), n_parts=4,
                           precision="f64", boundary_solver="cg")
    assert mix.cg_tol == 1e-5
    assert f64.cg_tol == 1e-12
    assert mix.cg_max_iters == 400


@pytest.mark.parametrize("boundary_solver", ["dense", "cg"])
def test_converges_from_large_initial_lambda(boundary_solver):
    """Heavy initial damping must still converge: the damped boundary
    system is S + lam*I (SPD for any lam >= 0). A damping SIGN flip makes
    S - lam*I indefinite at lam ~ 1e4, so the Cholesky fails (dense) or CG
    diverges, every step is rejected, and the solve stalls — this pins the
    '+' in both boundary paths, which small-lambda tests never exercise."""
    constraints, x0 = _coupled_chain_problem()
    cfg = Config(initial_lambda=1e4, max_iterations=120)
    out = BlockSchurSolver(constraints, len(x0), n_parts=4, config=cfg,
                           boundary_solver=boundary_solver).solve(x0)
    assert out["converged"]
    assert bool(np.asarray(out["satisfied"]).all())


def test_cg_option_actually_runs_cg(monkeypatch):
    """boundary_solver='cg' must dispatch to the PCG loop (not silently
    fall back to the dense branch). Probe by breaking _pcg."""
    import ezpz_jax.parallel.hier as hier_mod

    def boom(*a, **k):
        raise RuntimeError("pcg probe")

    monkeypatch.setattr(hier_mod, "_pcg", boom)
    constraints, x0 = _coupled_chain_problem()
    with pytest.raises(RuntimeError, match="pcg probe"):
        BlockSchurSolver(constraints, len(x0), n_parts=4,
                         boundary_solver="cg").solve(np.asarray(x0))
    # Dense path must be unaffected by the broken _pcg.
    out = BlockSchurSolver(constraints, len(x0), n_parts=4,
                           boundary_solver="dense").solve(np.asarray(x0))
    assert out["converged"]


# -- boundary_solver="auto" ---------------------------------------------------

def test_resolve_boundary_solver_policy():
    """The structural auto policy (schur.resolve_boundary_solver): banded
    for thin bands, dense for small boundaries, CG for large non-chain
    couplings; explicit choices pass through untouched."""
    from ezpz_jax.parallel.schur import resolve_boundary_solver as r

    assert r("auto", n_b=100, band_bw=5) == "banded"       # 4*6 <= 100
    assert r("auto", n_b=100, band_bw=40) == "dense"       # band too fat
    assert r("auto", n_b=500, band_bw=200) == "cg"         # big + fat band
    assert r("auto", n_b=0, band_bw=0) == "dense"          # uncoupled
    assert r("auto", n_b=100, band_bw=5, banded_ok=False) == "dense"
    assert r("auto", n_b=500, band_bw=5, banded_ok=False) == "cg"
    for explicit in ("dense", "cg", "banded"):
        assert r(explicit, n_b=500, band_bw=2) == explicit


def test_auto_picks_banded_on_long_chain_and_matches_dense():
    """A long chain of parts has a thin-banded Schur complement: auto must
    resolve to 'banded' and (the step being exact) produce the dense
    path's answer with the dense path's iteration count."""
    constraints, x0 = _coupled_chain_problem(n_blocks=40, pts_per_block=3)
    auto = BlockSchurSolver(constraints, len(x0), n_parts=40,
                            boundary_solver="auto", precision="f64")
    assert auto.boundary_solver == "banded", (
        auto.boundary_solver, auto.n_b, auto.band_bw)
    dense = BlockSchurSolver(constraints, len(x0), n_parts=40,
                             boundary_solver="dense", precision="f64")
    oa, od = auto.solve(x0), dense.solve(x0)
    assert oa["converged"] and od["converged"]
    assert oa["iterations"] == od["iterations"]
    np.testing.assert_allclose(oa["x"], od["x"], atol=1e-8)


def test_auto_picks_dense_on_small_boundary():
    constraints, x0 = _coupled_chain_problem(n_blocks=3, pts_per_block=4)
    s = BlockSchurSolver(constraints, len(x0), n_parts=3,
                         boundary_solver="auto")
    assert s.boundary_solver == "dense", (s.boundary_solver, s.band_bw)
    out = s.solve(x0)
    assert out["converged"] and bool(np.asarray(out["satisfied"]).all())


def test_banded_boundary_under_batch_vmap():
    """The banded direct solve is a lax.scan — it must survive vmap
    (solve_batch) unchanged: batched banded solves equal per-guess
    banded solves."""
    constraints, x0 = _coupled_chain_problem(n_blocks=16, pts_per_block=3)
    s = BlockSchurSolver(constraints, len(x0), n_parts=16,
                         boundary_solver="banded", precision="f64")
    rng = np.random.default_rng(7)
    x0s = np.stack([x0 + rng.uniform(-0.05, 0.05, len(x0)) for _ in range(3)])
    res, sat = s.solve_batch(x0s)
    assert bool(np.asarray(res.converged).all())
    assert bool(np.asarray(sat).all())
    for i in range(3):
        single = s.solve(x0s[i])
        assert single["iterations"] == int(np.asarray(res.iterations)[i])
        np.testing.assert_allclose(np.asarray(res.x)[i], single["x"],
                                   atol=1e-12)


def test_banded_step_equals_dense_step_exactly():
    """White-box: the banded boundary path is an EXACT direct solve, so a
    single damped Schur step must equal the dense path's step to f64
    round-off — iteration-level agreement alone can't see a corrupted
    band (LM absorbs inexact steps on easy chains; e.g. dropping every
    off==0 band entry still converged in the same iteration count)."""
    import jax.numpy as jnp

    constraints, x0 = _coupled_chain_problem(n_blocks=10, pts_per_block=3)
    n = len(x0)
    dense = BlockSchurSolver(constraints, n, n_parts=10, precision="f64",
                             boundary_solver="dense")
    banded = BlockSchurSolver(constraints, n, n_parts=10, precision="f64",
                              boundary_solver="banded")
    assert banded.band_bw > 0
    x = jnp.asarray(x0)
    for lam in (1e-10, 1e-3, 10.0):
        dd, fd, _ = dense._schur_step(x, jnp.asarray(lam))
        db, fb, _ = banded._schur_step(x, jnp.asarray(lam))
        assert not bool(fd) and not bool(fb)
        assert float(jnp.max(jnp.abs(dd))) > 0  # a genuine step
        np.testing.assert_allclose(np.asarray(db), np.asarray(dd),
                                   rtol=0, atol=1e-10, err_msg=f"lam={lam}")


def test_banded_step_exact_with_full_span_entry():
    """Chain fixtures leave the band's OUTERMOST diagonal exactly zero
    (band_bw over-estimates their true coupling distance), so they can't
    see a corrupted band edge. A triangle coupling (parts 0-1, 1-2, AND
    0-2) puts a direct nonzero at the full span — the banded step must
    still equal the dense step to f64 round-off."""
    import jax.numpy as jnp

    cs = [
        Constraint.Fixed(0, 0.0), Constraint.Fixed(3, 2.0),
        Constraint.Fixed(5, 5.0),
        Constraint.ScalarEqual(0, 1), Constraint.ScalarEqual(2, 3),
        Constraint.ScalarEqual(4, 5),
        Constraint.ScalarEqual(1, 2),   # parts 0-1
        Constraint.ScalarEqual(2, 4),   # parts 1-2
        Constraint.ScalarEqual(1, 4),   # parts 0-2: entry at the band edge
    ]
    pov = np.array([0, 0, 1, 1, 2, 2])
    x0 = jnp.asarray(np.arange(6, dtype=float) * 0.7 + 0.3)
    dense = BlockSchurSolver(cs, 6, part_of_var=pov, precision="f64",
                             boundary_solver="dense")
    banded = BlockSchurSolver(cs, 6, part_of_var=pov, precision="f64",
                              boundary_solver="banded")
    assert banded.band_bw == 2 and banded.n_b == 3
    dd, fd, _ = dense._schur_step(x0, jnp.asarray(1e-3))
    db, fb, _ = banded._schur_step(x0, jnp.asarray(1e-3))
    assert not bool(fd) and not bool(fb)
    np.testing.assert_allclose(np.asarray(db), np.asarray(dd),
                               rtol=0, atol=1e-12)


def test_banded_option_actually_runs_banded(monkeypatch):
    """boundary_solver='banded' must dispatch to the banded direct solve
    and 'dense' must NOT: the band covers every Schur entry (all
    contributions are within-part blocks), so a swapped dispatch is
    value-invisible and only a path probe can pin it."""
    import ezpz_jax.ops.banded as banded_mod

    def boom(*a, **k):
        raise RuntimeError("banded probe")

    monkeypatch.setattr(banded_mod, "banded_spd_solve", boom)
    constraints, x0 = _coupled_chain_problem()
    with pytest.raises(RuntimeError, match="banded probe"):
        BlockSchurSolver(constraints, len(x0), n_parts=4,
                         boundary_solver="banded").solve(np.asarray(x0))
    out = BlockSchurSolver(constraints, len(x0), n_parts=4,
                           boundary_solver="dense").solve(np.asarray(x0))
    assert out["converged"]
