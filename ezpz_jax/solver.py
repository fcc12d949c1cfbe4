"""Levenberg-Marquardt solve as a jit-compiled ``lax.while_loop``.

Reproduces the reference's iteration semantics exactly
(``ezpz/src/solver/newton.rs:29-145``):

* residual-tolerance check at the *top* of each iteration (inf-norm of the
  weighted residual), returning ``iterations = k`` = number of steps taken;
* damped normal equations ``(JtJ + lambda I) d = -Jt r`` solved by Cholesky;
* a numeric factorization failure counts as a rejected step: ``lambda *= 10``
  and continue (``newton.rs:96-99``);
* a step is accepted iff it strictly reduces the squared residual norm;
  accepted: ``lambda *= 0.1``; rejected: revert and ``lambda *= 10``;
* step-size convergence check (inf-norm of d) at the *bottom*, also reporting
  ``iterations = k`` (the index of the iteration that took the step);
* hitting ``max_iterations`` reports ``converged = False``.

The branchy accept/reject becomes ``jnp.where`` selects; Cholesky failure is
detected by NaNs in the factor (XLA's potrf yields NaN on non-SPD input
instead of raising, which is exactly the signal we need inside a traced loop).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .config import LM_LAMBDA_DECR, LM_LAMBDA_INCR
from .models.compiled import CompiledSystem
from .ops.linalg import spd_solve


class LMState(NamedTuple):
    x: jnp.ndarray
    r: jnp.ndarray
    r2: jnp.ndarray
    lam: jnp.ndarray
    it: jnp.ndarray
    done: jnp.ndarray
    converged: jnp.ndarray
    iterations: jnp.ndarray
    deg: jnp.ndarray  # (n_constraints,) bool — any degenerate eval during solve


class LMResult(NamedTuple):
    x: jnp.ndarray
    iterations: jnp.ndarray
    converged: jnp.ndarray
    deg: jnp.ndarray
    residual: jnp.ndarray  # weighted residual at the final x


def _init_state(system, x0, initial_lambda, lam_dtype=None, pars=None,
                deg_extra=None):
    """Initial LM carry: residual (+ flags) evaluated at the cast x0."""
    dtype = system.dtype
    r0, deg0 = system.residual_and_flags(x0.astype(dtype), pars)
    if deg_extra is not None:
        deg0 = deg0 | deg_extra
    return LMState(
        x=x0.astype(dtype),
        r=r0,
        r2=jnp.sum(r0 * r0),
        lam=jnp.asarray(initial_lambda, lam_dtype or dtype),
        it=jnp.asarray(0, jnp.int32),
        done=jnp.asarray(False),
        converged=jnp.asarray(False),
        iterations=jnp.asarray(0, jnp.int32),
        deg=deg0,
    )


def _lm_while_loop(state, eval_fn, step_fn, limit, rtol, stol,
                   boundary_parity: bool, debug_fn=None):
    """The shared LM accept/reject loop.

    The reference checks the residual tolerance at the TOP of each iteration
    (newton.rs:50-60). That check lives in BOTH places here:
    - in ``cond``: an unbatched solve exits without paying for a final
      detection pass of the body (a third of the work for typical
      2-iteration solves);
    - as per-lane predication (``act``) in the body: under ``vmap`` the
      batched while_loop keeps running until the slowest lane finishes, and
      converged lanes must FREEZE — continuing to step them would drift
      underconstrained solutions and corrupt per-lane iteration counts.
      (Frozen lanes also include step-converged ones.)

    ``step_fn(s) -> (d, fail, deg_j)`` computes the damped step (and the
    Jacobian pass's degenerate flags); ``eval_fn(x) -> (r, deg)`` evaluates
    the trial residual. A failed factorization is a rejected step and never
    counts as step-size convergence.

    ``boundary_parity``: the reference never re-checks the residual after
    its final iteration (newton.rs:47-60,141-144) — with True, residual
    convergence only counts while steps remain, matching that exactly; the
    f64 refinement passes False (its ``converged`` is a pure verification
    statement). Returns ``(final_state, res_conv)``.
    """

    def cond(s: LMState):
        return (~s.done) & (s.it < limit) & (jnp.max(jnp.abs(s.r)) > rtol)

    def body(s: LMState) -> LMState:
        res_now = (jnp.max(jnp.abs(s.r)) <= rtol) & ~s.done
        if boundary_parity:
            res_now = res_now & (s.it < limit)
        act = ~s.done & ~res_now

        if debug_fn is not None:
            debug_fn(s)
        d, fail, deg_j = step_fn(s)
        step_inf = jnp.max(jnp.abs(d))

        x_new = s.x + d
        r_new, deg_r = eval_fn(x_new)
        r2_new = jnp.sum(r_new * r_new)
        accept = jnp.logical_and(~fail, r2_new < s.r2)

        take = act & accept
        x = jnp.where(take, x_new, s.x)
        r = jnp.where(take, r_new, s.r)
        r2 = jnp.where(take, r2_new, s.r2)
        lam = jnp.where(
            act,
            jnp.where(accept, s.lam * LM_LAMBDA_DECR, s.lam * LM_LAMBDA_INCR),
            s.lam,
        )
        deg = s.deg | jnp.where(act, deg_j | deg_r, jnp.zeros_like(deg_j))

        # Step-size convergence at the bottom (newton.rs:134-139); reports
        # the index of the iteration that took the step.
        step_conv = act & (~fail) & (step_inf <= stol)
        done = s.done | res_now | step_conv
        iterations = jnp.where(res_now | step_conv, s.it, s.iterations)
        return LMState(
            x=x,
            r=r,
            r2=r2,
            lam=lam,
            it=jnp.where(act, s.it + 1, s.it),
            done=done,
            converged=s.converged | res_now | step_conv,
            iterations=iterations,
            deg=deg,
        )

    final = jax.lax.while_loop(cond, body, state)
    res_conv = jnp.max(jnp.abs(final.r)) <= rtol
    if boundary_parity:
        res_conv = res_conv & (final.it < limit)
    return final, res_conv


def _reference_result(final: LMState, res_conv, max_iterations: int) -> LMResult:
    """Reference-exact outcome assembly: residual convergence reports
    iterations = steps taken so far (newton.rs:50-60); step convergence
    pinned its index inside the loop; an exhausted budget reports
    max_iterations with converged = False."""
    iterations = jnp.where(
        final.done,
        final.iterations,
        jnp.where(res_conv, final.it, jnp.asarray(max_iterations, jnp.int32)),
    )
    return LMResult(
        x=final.x,
        iterations=iterations,
        converged=final.converged | res_conv,
        deg=final.deg,
        residual=final.r,
    )


def damped_spd_solve(jtj, lam, eye, b, spd=spd_solve):
    """``spd_solve(jtj + lam*eye, b)`` with an f32 singular-rescue retry.

    In f64 this is one plain factorization (reference-exact,
    ``newton.rs:15``). In f32 — the mixed path's coarse phase and
    refinement — a rank-deficient JtJ (any underconstrained sketch: a lone
    distance constraint leaves its tangential direction free) plus ``lam``
    below f32 round-off is numerically non-SPD: the Cholesky FAILS at
    lam = 1e-9 and 1e-8, burning the first two iterations of every such
    solve on rejected steps until the schedule escalates past ~1e-7
    (measured: 2 wasted trips per solve at every coordinate scale).

    An unconditional damping floor is NOT the fix: large coupled systems
    legitimately have softest-mode curvatures near f32 round-off (a
    600-part chain's smallest JtJ eigenvalue is ~3e-6), and flooring lam
    there slows convergence 2 -> 11 iterations. Instead: factor with the
    raw lam, and where that FAILS re-factor with lam floored at
    1e-6 * max|diag| (just above f32 round-off for the matrix's scale).
    Well-conditioned and ill-conditioned systems keep exact reference
    damping; only genuinely-singular lanes take the rescue. The carried
    ``lam`` and its schedule are untouched either way."""
    d, fail = spd(jtj + lam * eye, b)
    if np.dtype(jtj.dtype) != np.float32:
        return d, fail
    floor = np.float32(1e-6) * jnp.max(jnp.abs(jnp.diagonal(jtj)))
    d2, fail2 = spd(jtj + jnp.maximum(lam, floor) * eye, b)
    return jnp.where(fail, d2, d), fail & fail2


def solve_lm(
    system: CompiledSystem,
    x0: jnp.ndarray,
    max_iterations: int,
    residual_tolerance,
    step_tolerance,
    initial_lambda,
    pars=None,
    debug_jac: bool = False,
    spd=spd_solve,
) -> LMResult:
    """Run the LM loop on one system. Pure and jit/vmap-compatible.

    ``pars`` optionally overrides the per-block parameter arrays (dynamic
    parameters for the fleet-batching path). ``debug_jac`` (static) prints
    the dense weighted Jacobian every iteration — the analog of the
    reference's ``dbg-jac`` compile-time feature (``solver.rs:370-439``,
    ``ezpz/Cargo.toml:16``); enable via ``EZPZ_DBG_JAC=1`` on the
    public API."""
    dtype = system.dtype
    eye = jnp.eye(system.n_vars, dtype=dtype)
    rtol = jnp.asarray(residual_tolerance, dtype)
    stol = jnp.asarray(step_tolerance, dtype)
    state = _init_state(system, x0, initial_lambda, pars=pars)

    def step(s: LMState):
        _r, jtj, jtr, deg_j = system.normal_equations(s.x, pars)
        d, fail = damped_spd_solve(jtj, s.lam, eye, -jtr, spd=spd)
        return d, fail, deg_j

    debug_fn = None
    if debug_jac:
        def debug_fn(s):
            jax.debug.print(
                "dbg-jac: iteration {it}, dense Jacobian =\n{j}",
                it=s.it, j=system.jacobian_dense(s.x, pars),
            )

    final, res_conv = _lm_while_loop(
        state, lambda x: system.residual_and_flags(x, pars), step,
        max_iterations, rtol, stol, boundary_parity=True, debug_fn=debug_fn,
    )
    return _reference_result(final, res_conv, max_iterations)


def solve_gauss_newton(
    system: CompiledSystem,
    x0: jnp.ndarray,
    max_iterations: int,
    residual_tolerance,
    step_tolerance,
    initial_lambda,
    pars=None,
) -> LMResult:
    """Plain damped Gauss-Newton with a *fixed* damping parameter — the
    reference retains this variant alongside LM (``newton.rs:150-228``).
    No accept/reject: every step is taken."""
    dtype = system.dtype
    n = system.n_vars
    eye = jnp.eye(n, dtype=dtype)
    lam = jnp.asarray(initial_lambda, dtype)
    rtol = jnp.asarray(residual_tolerance, dtype)
    stol = jnp.asarray(step_tolerance, dtype)

    # Unlike LM, GN has no accept/reject, so the residual never needs to be
    # carried across iterations: the body's ``normal_equations`` evaluates a
    # fresh r at the current x, and the final residual (+ flags at the final
    # point) is evaluated once after the loop.
    state = dict(
        x=x0.astype(dtype),
        it=jnp.asarray(0, jnp.int32),
        done=jnp.asarray(False),
        converged=jnp.asarray(False),
        iterations=jnp.asarray(0, jnp.int32),
        deg=jnp.zeros((system.n_constraints,), jnp.bool_),
    )

    def cond(s):
        return jnp.logical_and(~s["done"], s["it"] < max_iterations)

    def body(s):
        r, jtj, jtr, deg_j = system.normal_equations(s["x"], pars)
        res_conv = jnp.max(jnp.abs(r)) <= rtol
        act = ~res_conv

        d, fail = damped_spd_solve(jtj, lam, eye, -jtr)
        step_inf = jnp.max(jnp.abs(d))

        # A factorization failure must not step (d is zero-filled) and must
        # NOT count as step-size convergence — without this guard a non-SPD
        # system would silently report converged=True at the unsolved point.
        x = jnp.where(act & ~fail, s["x"] + d, s["x"])
        deg = s["deg"] | jnp.where(act, deg_j, jnp.zeros_like(deg_j))
        step_conv = act & (~fail) & (step_inf <= stol)
        done = res_conv | step_conv
        return dict(
            x=x,
            it=jnp.where(res_conv, s["it"], s["it"] + 1),
            done=done,
            converged=s["converged"] | done,
            iterations=jnp.where(done, s["it"], s["iterations"]),
            deg=deg,
        )

    final = jax.lax.while_loop(cond, body, state)
    iterations = jnp.where(
        final["done"], final["iterations"],
        jnp.asarray(max_iterations, jnp.int32),
    )
    r_final, deg_f = system.residual_and_flags(final["x"], pars)
    return LMResult(
        x=final["x"],
        iterations=iterations,
        converged=final["converged"],
        deg=final["deg"] | deg_f,
        residual=r_final,
    )


def _cg(matvec, b, x0, tol, max_iters):
    """Standard conjugate gradients on an SPD operator, jit-friendly."""

    def cond(s):
        x, r, p, rs, it = s
        return jnp.logical_and(rs > tol * tol, it < max_iters)

    def body(s):
        x, r, p, rs, it = s
        ap = matvec(p)
        alpha = rs / jnp.vdot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = jnp.vdot(r, r)
        p = r + (rs_new / rs) * p
        return (x, r, p, rs_new, it + 1)

    r0 = b - matvec(x0)
    state = (x0, r0, r0, jnp.vdot(r0, r0), jnp.asarray(0, jnp.int32))
    x, _r, _p, _rs, _it = jax.lax.while_loop(cond, body, state)
    return x


def solve_lm_cg(
    system: CompiledSystem,
    x0: jnp.ndarray,
    max_iterations: int,
    residual_tolerance,
    step_tolerance,
    initial_lambda,
    pars=None,
    cg_tol: float = 1e-12,
    cg_max_iters: int = 400,
) -> LMResult:
    """LM with a matrix-free conjugate-gradient inner solve.

    For systems too large to materialize the dense (n, n) normal equations:
    (JtJ + lambda I) d = -Jt r is solved with CG using only per-block
    Jacobian factors (O(nnz) per matvec). Since lambda > 0 keeps the operator
    SPD, there is no factorization-failure path; everything else mirrors
    ``solve_lm``.
    """
    dtype = system.dtype
    rtol = jnp.asarray(residual_tolerance, dtype)
    stol = jnp.asarray(step_tolerance, dtype)
    state = _init_state(system, x0, initial_lambda, pars=pars)

    def step(s: LMState):
        _r, jtr, wjacs, deg_j = system.jacobian_factors(s.x, pars)
        lam = s.lam

        def matvec(v):
            return system.jtj_matvec(wjacs, v) + lam * v

        d = _cg(matvec, -jtr, jnp.zeros_like(s.x), cg_tol, cg_max_iters)
        # lambda > 0 keeps the operator SPD: CG has no factorization-failure
        # path.
        return d, jnp.asarray(False), deg_j

    final, res_conv = _lm_while_loop(
        state, lambda x: system.residual_and_flags(x, pars), step,
        max_iterations, rtol, stol, boundary_parity=True,
    )
    return _reference_result(final, res_conv, max_iterations)


def solve_lm_mixed(
    system64: CompiledSystem,
    system32: CompiledSystem,
    x0: jnp.ndarray,
    max_iterations: int,
    residual_tolerance,
    step_tolerance,
    initial_lambda,
    pars64=None,
    pars32=None,
    coarse_tolerance: float = 5e-6,
    refine_iterations: int = 6,
    coarse_max_iterations: int = 20,
    spd=spd_solve,
) -> LMResult:
    """Mixed-precision LM: f32 iterations + f64-residual refinement.

    An inf-norm residual of 1e-8 needs better-than-f32 accuracy only in
    the *residual evaluation* at the final point (SURVEY.md section 7), so
    most of the work can run at f32 rates:

    1. run the standard LM loop entirely in f32 down to ``coarse_tolerance``
       (just above f32 round-off for O(1) coordinates);
    2. refine with LM iterations whose residual (and accept/reject ``r2``)
       are evaluated in f64 but whose Jacobian, normal equations, and
       Cholesky stay f32: classic inexact Newton / iterative refinement —
       with |r| ~ 1e-6, f32 *relative* error on J gives ~1e-13 *absolute*
       step error, converging the f64 residual quadratically to < 1e-8.

    Semantics vs ``solve_lm``: identical accept/reject, lambda schedule, and
    failure handling; ``iterations`` counts phase-1 + phase-2 steps, which
    does NOT reproduce the reference's pinned iteration counts (use the pure
    f64 path when those matter). Intended for the high-throughput fleet and
    benchmark paths.
    """
    # Phase 1 is capped at ``coarse_max_iterations``: the reject cascade
    # that eventually step-converges below f32 round-off is wasted f32
    # work — the f64 refinement below has full LM semantics and finishes
    # from any reasonable coarse point.
    #
    # Residuals are homogeneous degree 1 in length (SURVEY.md section 2
    # invariants), so f32 round-off on them scales with the coordinate
    # magnitude: the coarse tolerance (5e-6, just above f32 round-off for
    # O(1) coordinates) and the step floor (1e-7, where f32 steps stagnate
    # for O(1) coordinates) both scale by max(1, |x0|_inf). Without this, a
    # sketch with coordinates ~1e4 burns the whole f32 budget chasing an
    # unreachable absolute 5e-6 and leans entirely on the refine phase.
    scale = jnp.maximum(
        jnp.asarray(1.0, system32.dtype),
        jnp.max(jnp.abs(x0)).astype(system32.dtype),
    )
    coarse = solve_lm(
        system32,
        x0.astype(system32.dtype),
        min(max_iterations, coarse_max_iterations),
        jnp.asarray(coarse_tolerance, system32.dtype) * scale,
        jnp.maximum(jnp.asarray(step_tolerance, system32.dtype), 1e-7 * scale),
        initial_lambda,
        pars=pars32,
        spd=spd,
    )
    return solve_lm_refine(
        system64, system32, coarse.x, coarse.iterations, coarse.deg,
        max_iterations, residual_tolerance, step_tolerance, initial_lambda,
        pars64=pars64, pars32=pars32, refine_iterations=refine_iterations,
        spd=spd,
    )


def solve_lm_refine(
    system64: CompiledSystem,
    system32: CompiledSystem,
    x_coarse: jnp.ndarray,
    coarse_iterations,
    coarse_deg,
    max_iterations: int,
    residual_tolerance,
    step_tolerance,
    initial_lambda,
    pars64=None,
    pars32=None,
    refine_iterations: int = 6,
    spd=spd_solve,
) -> LMResult:
    """The f64-residual refinement phase of ``solve_lm_mixed``, callable on
    its own so a coarse phase computed elsewhere can hand over: takes the coarse solution, its iteration count, and its
    degenerate flags, and runs f64-residual / f32-Jacobian LM iterations to
    the full tolerance. Reported iterations include the coarse count and
    never exceed ``max_iterations``."""
    f64 = system64.dtype
    n = system64.n_vars
    eye32 = jnp.eye(n, dtype=system32.dtype)
    rtol = jnp.asarray(residual_tolerance, f64)
    stol = jnp.asarray(step_tolerance, f64)
    coarse_iterations = jnp.asarray(coarse_iterations, jnp.int32)
    # The refinement budget respects the caller's total iteration cap:
    # coarse + refine never exceeds max_iterations.
    refine_limit = jnp.clip(
        jnp.asarray(max_iterations, jnp.int32) - coarse_iterations,
        0,
        refine_iterations,
    )

    state = _init_state(system64, x_coarse, initial_lambda,
                        lam_dtype=system32.dtype, pars=pars64,
                        deg_extra=coarse_deg)

    def step(s: LMState):
        jtj, jtr, deg_j = system32.refine_normal_equations(s.x, s.r, pars32)
        d32, fail = damped_spd_solve(jtj, s.lam, eye32, -jtr, spd=spd)
        return d32.astype(f64), fail, deg_j

    # boundary_parity=False: the refine's ``converged`` is a pure
    # verification statement (f64 residual within tolerance), independent of
    # where in the budget that happened.
    final, res_conv = _lm_while_loop(
        state, lambda x: system64.residual_and_flags(x, pars64), step,
        refine_limit, rtol, stol, boundary_parity=False,
    )
    refine_count = jnp.where(
        final.done,
        final.iterations,
        jnp.where(res_conv, final.it, refine_limit),
    )
    return LMResult(
        x=final.x,
        iterations=coarse_iterations + refine_count,
        converged=final.done | res_conv,
        deg=final.deg,
        residual=final.r,
    )


def make_solver(system: CompiledSystem, max_iterations: int,
                precision: str = "f64"):
    """A jitted solver for one compiled topology. Tolerances and lambda stay
    dynamic so config tweaks don't recompile; max_iterations only bounds the
    loop and is static. ``EZPZ_DBG_JAC=1`` prints the dense Jacobian per
    iteration (the reference's ``dbg-jac`` feature).

    ``precision="mixed"`` (Config extension) swaps the
    loop for ``solve_lm_mixed``: f32 iterations, f64-residual refinement,
    the same 1e-8 f64 verification — iteration counts are then NOT
    comparable to the reference's pins (use "f64" where they matter).

    Returns ONE packed 1-D array ``[x (n_vars) | sat (n_cons) | deg (n_cons)
    | converged | iterations]`` rather than a result pytree: the public API
    materializes every field of every solve, and a single device buffer
    costs ONE device->host transfer instead of five (the reference's whole
    perf surface is single-solve latency, ``ezpz-cli/src/main.rs:96-100``). Unpack with ``unpack_solver_result``.
    """
    import os

    debug_jac = os.environ.get("EZPZ_DBG_JAC", "") not in ("", "0")
    fast_sat = system.all_weights_positive()
    system32 = system.astype(jnp.float32) if precision == "mixed" else None

    @partial(jax.jit, static_argnums=())
    def run(x0, residual_tolerance, step_tolerance, initial_lambda):
        if precision == "mixed":
            res = solve_lm_mixed(
                system, system32, x0, max_iterations, residual_tolerance,
                step_tolerance, initial_lambda,
            )
        else:
            res = solve_lm(
                system, x0, max_iterations, residual_tolerance, step_tolerance,
                initial_lambda, debug_jac=debug_jac,
            )
        if fast_sat:
            sat = system.satisfaction_from_residual(res.residual)
        else:
            sat = system.constraint_satisfaction(res.x)
        dt = res.x.dtype
        return jnp.concatenate([
            res.x,
            sat.astype(dt),
            res.deg.astype(dt),
            jnp.stack([res.converged.astype(dt),
                       res.iterations.astype(dt)]),
        ])

    return run


def unpack_solver_result(packed, n_vars: int, n_cons: int):
    """Split ``make_solver``'s packed host array back into
    ``(x, sat, deg, converged, iterations)`` numpy views."""
    x = packed[:n_vars]
    sat = packed[n_vars:n_vars + n_cons] != 0.0
    deg = packed[n_vars + n_cons:n_vars + 2 * n_cons] != 0.0
    converged = bool(packed[n_vars + 2 * n_cons])
    iterations = int(packed[n_vars + 2 * n_cons + 1])
    return x, sat, deg, converged, iterations
