"""Scenario batching: solve thousands of same-topology sketches at once.

This is data parallelism for a constraint solver (SURVEY.md section 2):
one compiled topology, ``vmap`` over initial guesses
and per-sketch constraint parameters. Each sketch runs the exact
reference-semantics LM loop (per-sketch lambda, accept/reject, convergence);
``vmap`` of ``lax.while_loop`` runs until every sketch in the batch is done,
with converged sketches predicated out.

The reference has no equivalent — its closest artifact is the
``massive_parallel_system`` fixture, 500 independent subsystems concatenated
into one sparse matrix and solved serially (``README.md:37-41``). Here those
become a batch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .config import Config
from .models.compiled import CompiledSystem
from .solver import solve_lm, solve_lm_mixed

# Topologies at or below this many lowered instances evaluate via the
# fully-unrolled (static-index, gather/scatter-free) path inside the fleet
# solvers — the tiny systems block decomposition produces. Larger
# topologies keep the padded gather path (unrolling grows the traced
# program linearly).
UNROLL_MAX_INSTANCES = 24


def _maybe_unroll(system: CompiledSystem):
    from .ops.unrolled import UnrolledSystem

    n_instances = sum(int(b.idx.shape[0]) for b in system.blocks)
    if 0 < n_instances <= UNROLL_MAX_INSTANCES:
        return UnrolledSystem(system)
    return system


def _pick_spd(system: CompiledSystem):
    """Per-topology normal-equation solver for these ALWAYS-BATCHED
    contexts:

    * n <= 24 — fully-unrolled Crout (inside ``spd_solve``);
    * n > 24 with a narrow ordering — the O(n*bw^2) scan BAND tier
      (``ops.banded.plan_band``: identity or RCM, bw <= 32), which keeps
      a long chain's cost linear in n where a dense factorization is
      cubic;
    * 24 < n <= 64 with no narrow ordering — the matmul-free
      column-sweep tier (``spd_solve_batched``);
    * n > 64 with no narrow ordering — XLA's dense tier.

    The split is not yet measured on the GPU (ROADMAP Design D4)."""
    from .ops.linalg import (UNROLL_COL_MAX_N, UNROLL_MAX_N, spd_solve,
                             spd_solve_batched)

    n = system.n_vars
    if n > UNROLL_MAX_N:
        from .ops.banded import make_banded_spd, plan_band

        plan = plan_band(system)
        if plan is not None:
            perm, bw = plan
            return make_banded_spd(n, bw, perm)
    if UNROLL_MAX_N < n <= UNROLL_COL_MAX_N:
        return spd_solve_batched
    return spd_solve


@dataclass
class BatchResult:
    x: jnp.ndarray  # (B, n_vars)
    iterations: jnp.ndarray  # (B,)
    converged: jnp.ndarray  # (B,) bool
    satisfied: jnp.ndarray  # (B, n_constraints) bool
    degenerate: jnp.ndarray  # (B, n_constraints) bool


class BatchSolver:
    """A jit-compiled vmapped LM solver for one topology.

    ``pars`` (optional) is a tuple of (B, n_k, np_k) arrays aligned with
    ``system.blocks`` — per-sketch constraint parameters. Without it, all
    sketches share the compile-time parameters and only guesses vary.

    Solve three sketches of the same topology (pin p, hold q at distance 5)
    from different guesses in one vmapped call:

    >>> import numpy as np
    >>> from ezpz_jax import Constraint, DatumPoint
    >>> from ezpz_jax.batch import BatchSolver
    >>> from ezpz_jax.config import Config
    >>> from ezpz_jax.models.compiled import compile_system
    >>> p, q = DatumPoint(0, 1), DatumPoint(2, 3)
    >>> system = compile_system([Constraint.Fixed(0, 0.0),
    ...                          Constraint.Fixed(1, 0.0),
    ...                          Constraint.Distance(p, q, 5.0)], n_vars=4)
    >>> x0 = np.array([[0.0, 0.0, 3.0, 3.9],
    ...                [0.0, 0.0, 2.9, 4.1],
    ...                [0.0, 0.0, 4.1, 2.8]])
    >>> res = BatchSolver(system, Config()).solve(x0)
    >>> bool(np.asarray(res.converged).all())
    True
    >>> np.allclose(np.hypot(np.asarray(res.x)[:, 2], np.asarray(res.x)[:, 3]), 5.0)
    True
    """

    def __init__(self, system: CompiledSystem, config: Config = Config(),
                 batch_params: bool = False, precision: str = "f64"):
        """``precision``:

        * ``"f64"`` (default) — the reference-exact f64 LM loop;
        * ``"mixed"`` — f32 LM + f64-residual refinement
          (``solve_lm_mixed``): still verified to the f64 residual
          tolerance, but iteration counts do not match the reference's
          pinned values.
        """
        assert precision in ("f64", "mixed"), precision
        self.system = system
        self.config = config
        self.batch_params = batch_params
        self.precision = precision
        self._analysis_run = None
        max_iterations = config.max_iterations
        # Small topologies solve via the unrolled (static-index) evaluator.
        ev64 = _maybe_unroll(system)
        ev32 = (
            _maybe_unroll(system.astype(jnp.float32))
            if precision == "mixed" else None
        )

        # With strictly positive weights, satisfaction comes free from the
        # final weighted residual (one full f64 residual pass saved/solve).
        fast_sat = system.all_weights_positive()

        # Size-tiered normal-equation solver (column sweep / band / dense
        # — see _pick_spd).
        spd = _pick_spd(system)

        def solve_one(x0, pars, rtol, stol, lam0):
            if precision == "mixed":
                pars32 = (
                    None if pars is None
                    else tuple(p.astype(jnp.float32) for p in pars)
                )
                res = solve_lm_mixed(
                    ev64, ev32, x0, max_iterations, rtol, stol, lam0,
                    pars64=pars, pars32=pars32, spd=spd,
                )
            else:
                res = solve_lm(ev64, x0, max_iterations, rtol, stol, lam0,
                               pars=pars, spd=spd)
            if fast_sat:
                sat = system.satisfaction_from_residual(res.residual)
            else:
                sat = system.constraint_satisfaction(res.x, pars)
            return res, sat

        # The unjitted vmapped solver is kept for FleetSolver, which jits
        # the SAME callable with device shardings — guaranteeing the
        # multi-device XLA path is the single-device path by construction.
        if batch_params:
            self._vmapped = jax.vmap(solve_one, in_axes=(0, 0, None, None, None))
        else:
            self._vmapped = jax.vmap(
                lambda x0, rtol, stol, lam0: solve_one(x0, None, rtol, stol, lam0),
                in_axes=(0, None, None, None),
            )
        self._run = jax.jit(self._vmapped)

    def solve(self, x0: jnp.ndarray, pars: Optional[Tuple] = None) -> BatchResult:
        c = self.config
        args = (x0,) + ((pars,) if self.batch_params else ())
        res, sat = self._run(
            *args, c.residual_tolerance, c.step_tolerance, c.initial_lambda
        )
        return BatchResult(
            x=res.x,
            iterations=res.iterations,
            converged=res.converged,
            satisfied=sat,
            degenerate=res.deg,
        )

    def solve_analysis(self, x0: jnp.ndarray, pars: Optional[Tuple] = None):
        """Solve the batch AND run freedom (DoF) analysis per sketch —
        the batched ``solve_analysis`` (``ezpz/src/lib.rs:134-144``,
        ``solver/find_dof.rs:15-104``) the reference computes one host QR
        at a time. Here the B dense Jacobians at the solved points and
        their nullspace participations are computed in ONE vmapped device
        SVD pass and ONE device->host transfer (loop-equivalence tested).

        Returns ``(BatchResult, [FreedomAnalysis] * B)``.
        """
        from .dof import participation_device, underconstrained_from_participation
        from .utils.errors import EmptySystemNotAllowed

        system = self.system
        if min(system.n_rows, system.n_vars) == 0:
            raise EmptySystemNotAllowed()
        res = self.solve(x0, pars)
        if self._analysis_run is None:
            if self.batch_params:
                fn = lambda x, p: participation_device(
                    system.jacobian_dense(x, p))
                self._analysis_run = jax.jit(jax.vmap(fn))
            else:
                fn = lambda x: participation_device(system.jacobian_dense(x))
                self._analysis_run = jax.jit(jax.vmap(fn))
        args = (res.x,) + ((pars,) if self.batch_params else ())
        parts, _null = self._analysis_run(*args)
        parts = np.asarray(parts)
        analyses = [underconstrained_from_participation(parts[i])
                    for i in range(parts.shape[0])]
        return res, analyses


class MultiTopologySolver:
    """Solve several same-config batches of DIFFERENT topologies in ONE
    jitted call.

    A decomposed system (``models.blocks``) yields one batch per topology
    bucket; dispatching them as separate executables costs one dispatch
    each and is a missed opportunity for XLA to overlap the buckets'
    compute. This fuses every bucket's vmapped LM loop into a single XLA computation.

    ``systems``: list of CompiledSystem. ``solve`` takes equal-length lists
    of initial-guess batches and per-sketch parameter tuples.
    """

    def __init__(self, systems, config: Config = Config(),
                 precision: str = "f64"):
        assert precision in ("f64", "mixed"), precision
        self.systems = list(systems)
        self.config = config
        max_iterations = config.max_iterations
        systems32 = [
            s.astype(jnp.float32) if precision == "mixed" else None
            for s in self.systems
        ]

        def run(x0s, parss, rtol, stol, lam0):
            outs = []
            for system, system32, x0b, pars in zip(
                self.systems, systems32, x0s, parss
            ):
                fast_sat = system.all_weights_positive()
                ev64 = _maybe_unroll(system)
                ev32 = _maybe_unroll(system32) if system32 is not None else None
                spd = _pick_spd(system)

                def one(x0, p, system=system, ev64=ev64, ev32=ev32,
                        fast_sat=fast_sat, spd=spd):
                    if precision == "mixed":
                        p32 = tuple(q.astype(jnp.float32) for q in p)
                        res = solve_lm_mixed(
                            ev64, ev32, x0, max_iterations, rtol, stol,
                            lam0, pars64=p, pars32=p32, spd=spd,
                        )
                    else:
                        res = solve_lm(ev64, x0, max_iterations, rtol, stol,
                                       lam0, pars=p, spd=spd)
                    if fast_sat:
                        sat = system.satisfaction_from_residual(res.residual)
                    else:
                        sat = system.constraint_satisfaction(res.x, p)
                    return res, sat

                outs.append(jax.vmap(one)(x0b, pars))
            return outs

        self._run = jax.jit(run)

    def solve(self, x0s, parss):
        c = self.config
        outs = self._run(list(x0s), list(parss), c.residual_tolerance,
                         c.step_tolerance, c.initial_lambda)
        return [
            BatchResult(x=res.x, iterations=res.iterations,
                        converged=res.converged, satisfied=sat,
                        degenerate=res.deg)
            for res, sat in outs
        ]
