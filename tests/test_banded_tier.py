"""The banded normal-equation tier (ops/banded.plan_band/make_banded_spd).

Without this tier, batched mid-size solves fall onto a DENSE Cholesky —
cubic in n for a 146-var chain whose RCM band is only 7 wide. The
reference never pays that because faer's sparse LLT fill-in on a banded
matrix IS the band (``ezpz/src/solver.rs:270,289-300``,
``newton.rs:87-102``); this tier is the batched equivalent: permute to
the narrowest identity/RCM band, factor with the O(n*bw^2) scan.
"""

import sys
import os

import numpy as np
import jax
import jax.numpy as jnp

import ezpz_jax  # noqa: F401
from ezpz_jax.batch import BatchSolver, _pick_spd
from ezpz_jax.config import Config
from ezpz_jax.constraints import Constraint
from ezpz_jax.datatypes import DatumPoint
from ezpz_jax.models.compiled import compile_system
from ezpz_jax.constraints import KernelInstance
from ezpz_jax.ops.banded import (BANDED_MAX_BW, _jtj_pattern, _rcm_order,
                                 make_banded_spd, plan_band)
from ezpz_jax.ops.linalg import spd_solve, spd_solve_batched

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benches"))
from midsize_bench import rect_chain, rect_grid  # noqa: E402



def _pars_for(system, B):
    return tuple(
        jnp.asarray(np.tile(np.asarray(b.par), (B, 1, 1)))
        for b in system.blocks
    )


def _shuffled_rect_chain(R: int, seed: int = 5):
    """rect_chain(R) with the VARIABLE NUMBERING shuffled (same constraint
    graph): the banded structure survives only through an elimination
    reordering."""
    cons, x0 = rect_chain(R)
    perm = np.random.default_rng(seed).permutation(len(x0))

    def relabel(c):
        return _Relabeled([
            KernelInstance(i.kernel, tuple(int(perm[v]) for v in i.var_ids),
                           i.params)
            for i in c.lower()])

    x0_s = np.zeros_like(x0)
    x0_s[perm] = x0
    return [relabel(c) for c in cons], x0_s


class _Relabeled:
    """Pre-lowered constraint (the ``.lower()`` protocol compile_system
    consumes)."""

    def __init__(self, instances):
        self.instances = instances

    def lower(self):
        return list(self.instances)


def _bandwidth(pat, order=None):
    if order is None:
        return max(i - j for (i, j) in pat)
    inv = np.empty(len(order), dtype=int)
    inv[np.asarray(order)] = np.arange(len(order))
    return max(abs(int(inv[i]) - int(inv[j])) for (i, j) in pat)


def test_rcm_order_tames_shuffled_numbering():
    """A shuffled chain has a banded GRAPH but a wide numbering: the RCM
    ordering must bring its band back to the well-ordered chain's RCM
    band, and plan_band must pick it (a permutation, not identity)."""
    cons, x0 = rect_chain(6)
    sys_ord = compile_system(cons, n_vars=len(x0))
    cons_s, x0_s = _shuffled_rect_chain(6)
    sys_shuf = compile_system(cons_s, n_vars=len(x0_s))
    n = sys_ord.n_vars

    def pattern(system):
        return _jtj_pattern([(None, [int(j) for j in b.idx[i]])
                             for b in system.blocks
                             for i in range(b.idx.shape[0])], n)

    pat_ord, pat_shuf = pattern(sys_ord), pattern(sys_shuf)
    rcm_ord = _rcm_order(pat_ord, n)
    rcm_shuf = _rcm_order(pat_shuf, n)
    assert sorted(rcm_shuf) == list(range(n))  # a permutation
    assert _bandwidth(pat_shuf, rcm_shuf) == _bandwidth(pat_ord, rcm_ord)
    assert _bandwidth(pat_shuf, rcm_shuf) < _bandwidth(pat_shuf) / 2
    perm, bw = plan_band(sys_shuf)
    assert perm is not None and bw == _bandwidth(pat_shuf, rcm_shuf)


def test_plan_band_chain_narrow_grid_wider_dense_none():
    cons, x0 = rect_chain(24)
    system = compile_system(cons, n_vars=len(x0))
    plan = plan_band(system)
    assert plan is not None
    _perm, bw = plan
    assert bw <= 8, bw  # RCM orders the chain to a one-rectangle band

    gcons, gx0 = rect_grid(5, 5)
    gsystem = compile_system(gcons, n_vars=len(gx0))
    gplan = plan_band(gsystem)
    assert gplan is not None
    assert bw < gplan[1] <= 2 * 14  # grid band ~ 2 columns of points

    # An expander-coupled topology has no narrow ordering -> None.
    rng = np.random.default_rng(0)
    dcons = []
    n_vars = 200
    for _ in range(250):
        a, b = rng.choice(n_vars // 2, size=2, replace=False)
        dcons.append(Constraint.Distance(
            DatumPoint(int(2 * a), int(2 * a + 1)),
            DatumPoint(int(2 * b), int(2 * b + 1)), 1.0))
    dsystem = compile_system(dcons, n_vars=n_vars)
    assert plan_band(dsystem) is None


def test_banded_spd_matches_dense_solver():
    """On the chain topology's actual JtJ + damping, the band tier must
    reproduce the dense solve to f64 round-off (same matrix, same rhs)."""
    cons, x0 = rect_chain(24)
    system = compile_system(cons, n_vars=len(x0))
    perm, bw = plan_band(system)
    spd_band = make_banded_spd(system.n_vars, bw, perm)

    pars = tuple(jnp.asarray(np.asarray(b.par)) for b in system.blocks)
    J = system.jacobian_dense(jnp.asarray(x0), pars)
    A = J.T @ J + 1e-6 * jnp.eye(system.n_vars)
    rng = np.random.default_rng(1)
    b = jnp.asarray(rng.normal(0, 1, system.n_vars))

    x_band, fail_b = jax.jit(spd_band)(A, b)
    x_ref, fail_r = jax.jit(spd_solve)(A, b)
    assert not bool(fail_b) and not bool(fail_r)
    np.testing.assert_allclose(np.asarray(x_band), np.asarray(x_ref),
                               rtol=1e-9, atol=1e-9)


def test_banded_spd_nonspd_fails_cleanly():
    """Indefinite matrix -> fail=True, zero-filled x (the spd_solve
    contract the LM loop's re-damping depends on, newton.rs:96-99)."""
    n, bw = 70, 3
    spd_band = make_banded_spd(n, bw, None)
    A = -jnp.eye(n)
    b = jnp.ones(n)
    x, fail = jax.jit(spd_band)(A, b)
    assert bool(fail)
    assert np.allclose(np.asarray(x), 0.0)


def test_pick_spd_tiers():
    """Narrow-ordering topologies take the band tier from n > 24 (its cost
    is linear in n); mid-size with NO narrow ordering keeps the
    column-sweep tier; large with no narrow ordering falls to dense."""
    for R in (8, 24):  # 50 and 146 vars, both band-narrow
        cons, x0 = rect_chain(R)
        s = compile_system(cons, n_vars=len(x0))
        spd = _pick_spd(s)
        assert spd is not spd_solve and spd is not spd_solve_batched, R

    # 25 decoupled vars coupled pairwise at long range: n in (24, 64]
    # with bandwidth > 32 under any ordering -> column sweep.
    rng = np.random.default_rng(2)
    mcons = []
    for _ in range(80):
        a, b = rng.choice(25, size=2, replace=False)
        mcons.append(Constraint.Distance(
            DatumPoint(int(2 * a), int(2 * a + 1)),
            DatumPoint(int(2 * b), int(2 * b + 1)), 1.0))
    smid = compile_system(mcons, n_vars=50)
    from ezpz_jax.ops.banded import plan_band as _pb
    if _pb(smid) is None:  # the random graph must actually be wide
        assert _pick_spd(smid) is spd_solve_batched

    dcons = []
    for _ in range(250):
        a, b = rng.choice(100, size=2, replace=False)
        dcons.append(Constraint.Distance(
            DatumPoint(int(2 * a), int(2 * a + 1)),
            DatumPoint(int(2 * b), int(2 * b + 1)), 1.0))
    sdense = compile_system(dcons, n_vars=200)
    assert _pick_spd(sdense) is spd_solve


def test_midsize_chain_solves_through_band_tier():
    """End-to-end: a 146-var chain batch through BatchSolver (mixed
    precision — the production mid-size path) must converge and verify at
    the f64 tolerance while riding the band tier."""
    cons, x0 = rect_chain(24)
    system = compile_system(cons, n_vars=len(x0))
    B = 8
    rng = np.random.default_rng(3)
    x0b = jnp.asarray(np.tile(x0, (B, 1)) + rng.normal(0, 0.01, (B, len(x0))))
    pars = _pars_for(system, B)
    solver = BatchSolver(system, Config(), batch_params=True,
                         precision="mixed")
    out = solver.solve(x0b, pars)
    assert bool(np.asarray(out.converged).all())
    assert bool(np.asarray(out.satisfied).all())
    r, _deg = jax.vmap(lambda x, *p: system.residual_and_flags(x, p))(
        jnp.asarray(out.x, jnp.float64), *pars)
    assert float(jnp.max(jnp.abs(r))) <= 1e-8


def test_pick_spd_unrolled_boundary_exact():
    """The unrolled tier's boundary is INCLUSIVE at n = UNROLL_MAX_N
    (24): a narrow 24-var topology stays on the fully-unrolled dense
    Crout (the measured-fastest tier at that size) and only 25+ routes
    to the band planner (mutation-found: `>` -> `>=` silently moved
    24-var chains onto the scan tier)."""
    from ezpz_jax.ops.linalg import UNROLL_MAX_N

    assert UNROLL_MAX_N == 24
    pts24 = [DatumPoint(2 * i, 2 * i + 1) for i in range(12)]
    cons24 = [Constraint.Fixed(pts24[0].x_id, 0.0),
              Constraint.Fixed(pts24[0].y_id, 0.0)]
    for a, b in zip(pts24, pts24[1:]):
        cons24.append(Constraint.Distance(a, b, 1.0))
    s24 = compile_system(cons24, n_vars=24)
    assert _pick_spd(s24) is spd_solve

    pts13 = [DatumPoint(2 * i, 2 * i + 1) for i in range(13)]
    cons26 = [Constraint.Fixed(pts13[0].x_id, 0.0),
              Constraint.Fixed(pts13[0].y_id, 0.0)]
    for a, b in zip(pts13, pts13[1:]):
        cons26.append(Constraint.Distance(a, b, 1.0))
    s26 = compile_system(cons26, n_vars=26)
    spd = _pick_spd(s26)
    assert spd is not spd_solve and spd is not spd_solve_batched


def test_band_tier_respects_max_bw():
    assert BANDED_MAX_BW == 32
    # A topology ordering to a band wider than the cap must not plan.
    rng = np.random.default_rng(4)
    cons = []
    n_pts = 60
    # couple each point to a point ~20 away: band ~40 even after RCM
    for i in range(n_pts - 20):
        cons.append(Constraint.Distance(
            DatumPoint(2 * i, 2 * i + 1),
            DatumPoint(2 * (i + 20), 2 * (i + 20) + 1), 1.0))
    system = compile_system(cons, n_vars=2 * n_pts)
    plan = plan_band(system)
    assert plan is None or plan[1] <= BANDED_MAX_BW
