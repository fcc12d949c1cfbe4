"""Public solve API: priority cascade, validation, satisfaction, warnings.

Mirrors ``ezpz/src/lib.rs``:

* ``solve(reqs, initial_guesses, config)`` — the priority cascade solves the
  highest-priority subset first, then keeps adding lower tiers until a tier
  fails or leaves constraints unsatisfied, returning the last fully-satisfied
  tier's solution (``lib.rs:199-246``). Each tier restarts from the original
  guesses.
* Undefined tangency sides are inferred from the initial values before
  solving (``lib.rs:183-186``).
* After the LM loop, every constraint is re-checked unweighted against
  ``EPSILON = 1e-4`` (``lib.rs:307-327``).
* Degenerate geometry produces warnings, not errors; non-convergence returns
  ``converged = False``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .config import Config
from .constraints import Constraint, ConstraintRequest
from .dof import freedom_analysis
from .models.compiled import CompiledSystem, compile_system, topology_key
from .outcomes import (
    FailureOutcome,
    FreedomAnalysis,
    SolveOutcome,
    SolveOutcomeFreedomAnalysis,
)
from .solver import make_solver, unpack_solver_result
from .utils.errors import MissingGuess, NotFound, WrongNumberGuesses
from .utils.ids import Id
from .utils.warnings import Warning, WarningKind, lint

# Cache of jitted solvers keyed by compiled topology, so repeated solves of
# the same sketch (priority tiers, CLI timing loops, tests) compile once.
# LRU: dicts iterate in insertion order, so evicting the first key drops the
# least-recently-used entry (hits re-insert) instead of recompiling the
# whole working set on overflow.
_SOLVER_CACHE: Dict[tuple, tuple] = {}
_SOLVER_CACHE_LIMIT = 256


def _validate_and_densify(
    entries: Sequence[Tuple[int, ConstraintRequest]],
    initial_guesses: Sequence[Tuple[Id, float]],
) -> np.ndarray:
    """Check every referenced variable has a guess (``solver.rs:142-189``)
    and build the flat variable vector indexed by id."""
    ids = [g[0] for g in initial_guesses]
    id_set = set(ids)
    if len(id_set) != len(ids):
        raise WrongNumberGuesses(labels=len(id_set), guesses=len(ids))
    n = len(ids)
    for vid in ids:
        if not (0 <= vid < n):
            raise NotFound(vid)
    for cid, req in entries:
        # dependent_variable_ids is the deduplicated union of nonzero_rows
        # (and memoized on the constraint) — same membership check, one
        # visit per variable.
        for vid in req.constraint.dependent_variable_ids():
            if vid not in id_set:
                raise MissingGuess(constraint_id=cid, variable=vid)
    x = np.zeros(n, dtype=np.float64)
    for vid, val in initial_guesses:
        x[vid] = val
    return x


# Sketches that decompose into at least this many independent components
# take the decomposed batched path (models.blocks.BlockProgram): one vmapped
# LM per topology bucket instead of one monolithic dense LM — the batched
# shape of the sparsity the reference's sparse-LLT Newton step exploits
# implicitly (newton.rs:15). Below the threshold the reference-exact global
# loop runs (identical damping schedule and iteration counts).
# EZPZ_DECOMPOSE_MIN overrides; 0 disables decomposition entirely.
_DECOMPOSE_MIN_DEFAULT = 32


def _decompose_min() -> int:
    import os

    raw = os.environ.get("EZPZ_DECOMPOSE_MIN", "")
    try:
        return int(raw) if raw else _DECOMPOSE_MIN_DEFAULT
    except ValueError:
        return _DECOMPOSE_MIN_DEFAULT


def _get_system_and_solver(constraints, weights, n_vars: int,
                           max_iterations: int, precision: str = "f64"):
    """Compiled system + jitted solver for this topology, LRU-cached.

    ``topology_key`` covers kernel ids, variable indices, AND parameter
    values, so a hit safely reuses the cached CompiledSystem too —
    re-solves of an identical problem (the CLI's 100x protocol,
    priority-tier repeats) skip ``compile_system``'s array building
    entirely, the dominant host cost once dispatches are pipelined.

    Returns either ``(CompiledSystem, jitted solver)`` or
    ``(BlockProgram, its solver)`` — both expose ``n_vars``,
    ``jacobian_dense`` and the same packed solver contract, so callers
    are path-agnostic."""
    import os

    if precision not in ("f64", "mixed"):
        raise ValueError(
            f"precision must be 'f64' or 'mixed', got {precision!r}")
    thresh = _decompose_min()
    dbg = os.environ.get("EZPZ_DBG_JAC", "")
    key = (
        topology_key(constraints, n_vars),
        tuple(weights),
        max_iterations,
        dbg,  # dbg-jac recompiles
        thresh,
        precision,
    )
    hit = _SOLVER_CACHE.pop(key, None)
    if hit is not None:
        _SOLVER_CACHE[key] = hit  # re-insert: now most-recently-used
        return hit

    system = solver = None
    # dbg-jac prints the GLOBAL dense Jacobian per iteration; keep it on
    # the monolithic path where that object exists.
    if thresh > 0 and dbg in ("", "0") and len(constraints) >= thresh:
        from .models.blocks import BlockProgram, connected_components

        if len(connected_components(constraints, n_vars)) >= thresh:
            program = BlockProgram(
                constraints, n_vars, list(weights), max_iterations,
                precision=precision,
            )
            if program.complete and program.n_components >= thresh:
                system, solver = program, program.solver
    if system is None:
        system = compile_system(constraints, n_vars=n_vars, weights=weights)
        solver = make_solver(system, max_iterations, precision=precision)
    while len(_SOLVER_CACHE) >= _SOLVER_CACHE_LIMIT:
        _SOLVER_CACHE.pop(next(iter(_SOLVER_CACHE)))  # evict oldest only
    _SOLVER_CACHE[key] = (system, solver)
    return system, solver


def _dispatch_solve(
    entries: Sequence[Tuple[int, ConstraintRequest]],
    initial_guesses: Sequence[Tuple[Id, float]],
    config: Config,
):
    """The host-side half of one tier's solve: lint, validate, compile (or
    hit the solver cache), and dispatch the jitted solver WITHOUT waiting
    for the result. Returns ``(packed_device_array, system, warnings)``.

    Splitting dispatch from materialization lets the CLI/bench timing loops
    stream re-solves: a synchronous solve pays one device->host transfer
    per solve, while pipelined re-solves overlap dispatch with device
    work."""
    num_vars = len(initial_guesses)
    warnings: List[Warning] = lint([(cid, req.constraint) for cid, req in entries])

    try:
        x0 = _validate_and_densify(entries, initial_guesses)
    except Exception as error:  # typed errors from validation
        raise FailureOutcome(
            error=error, warnings=warnings, num_vars=num_vars,
            num_eqs=sum(req.constraint.residual_dim() for _cid, req in entries),
        ) from None

    constraints = [req.constraint for _cid, req in entries]
    weights = [req.weight for _cid, req in entries]
    system, solver = _get_system_and_solver(
        constraints, weights, len(x0), config.max_iterations, config.precision
    )

    packed = solver(
        x0, config.residual_tolerance, config.step_tolerance, config.initial_lambda
    )
    return packed, system, warnings


def _solve_inner(
    entries: Sequence[Tuple[int, ConstraintRequest]],
    initial_guesses: Sequence[Tuple[Id, float]],
    config: Config,
    want_analysis: bool,
) -> Tuple[Optional[FreedomAnalysis], SolveOutcome]:
    num_vars = len(initial_guesses)
    packed, system, warnings = _dispatch_solve(entries, initial_guesses, config)
    # ONE device->host transfer for the whole outcome (x, satisfaction,
    # degenerate flags, converged, iterations): the packed layout keeps
    # single-solve latency at one device->host transfer.
    x_final, sat, deg, converged, iterations = unpack_solver_result(
        np.asarray(packed), system.n_vars, len(entries)
    )

    # Degenerate warnings, one per flagged constraint (the reference pushes a
    # warning per evaluation and can duplicate; we deduplicate).
    for local_idx, flagged in enumerate(deg):
        if flagged:
            warnings.append(
                Warning(about_constraint=entries[local_idx][0], content=WarningKind.DEGENERATE)
            )

    unsatisfied = [entries[i][0] for i in range(len(entries)) if not sat[i]]

    analysis: Optional[FreedomAnalysis] = None
    if want_analysis:
        try:
            if hasattr(system, "freedom_analysis"):
                # Decomposed path: per-bucket batched SVDs with the same
                # global thresholds (exact — the Jacobian is block-diagonal
                # up to a permutation), instead of one O(n^3) global SVD.
                analysis = system.freedom_analysis(x_final)
            else:
                analysis = freedom_analysis(
                    np.asarray(system.jacobian_dense(x_final))
                )
        except Exception as error:
            raise FailureOutcome(
                error=error, warnings=warnings, num_vars=num_vars,
                num_eqs=sum(
                    req.constraint.residual_dim() for _cid, req in entries
                ),
            ) from None

    priority_solved = max((req.priority for _cid, req in entries), default=0)
    outcome = SolveOutcome(
        unsatisfied=unsatisfied,
        converged=converged,
        final_values=[float(v) for v in x_final],
        iterations=iterations,
        warnings=warnings,
        priority_solved=priority_solved,
    )
    return analysis, outcome


def _resolve_entries(
    reqs: Sequence[ConstraintRequest],
    initial_guesses: Sequence[Tuple[Id, float]],
) -> List[Tuple[int, ConstraintRequest]]:
    """Tangency-side inference from the initial values (``lib.rs:172-186``),
    preserving each request's original index."""
    max_id = max((vid for vid, _ in initial_guesses), default=0)
    dense = [0.0] * (max_id + 1)
    for vid, val in initial_guesses:
        dense[vid] = val
    # set_from_initial_values returns self unless a tangency side actually
    # resolves; keeping the original request object in that (overwhelmingly
    # common) case preserves the per-constraint lower() memo across
    # re-solves — a profiled host-path win on many-constraint sketches.
    resolved = []
    for r in reqs:
        c = r.constraint.set_from_initial_values(dense)
        if c is r.constraint:
            resolved.append(r)
        else:
            resolved.append(ConstraintRequest(
                constraint=c, priority=r.priority, weight=r.weight))
    return list(enumerate(resolved))


def _solve_with_priority(
    reqs: Sequence[ConstraintRequest],
    initial_guesses: Sequence[Tuple[Id, float]],
    config: Config,
    want_analysis: bool,
) -> Tuple[Optional[FreedomAnalysis], SolveOutcome]:
    initial_guesses = list(initial_guesses)
    if not reqs:
        return (
            FreedomAnalysis([]) if want_analysis else None,
            SolveOutcome(
                unsatisfied=[],
                converged=True,
                final_values=[val for _id, val in initial_guesses],
                iterations=0,
                warnings=[],
                priority_solved=0,
            ),
        )

    entries = _resolve_entries(reqs, initial_guesses)
    priorities = sorted({req.priority for _cid, req in entries})

    best: Optional[Tuple[Optional[FreedomAnalysis], SolveOutcome]] = None
    for curr_max in priorities:
        subset = [(cid, req) for cid, req in entries if req.priority <= curr_max]
        try:
            result = _solve_inner(subset, initial_guesses, config, want_analysis)
        except FailureOutcome:
            if best is not None:
                return best
            raise
        if result[1].is_unsatisfied():
            return best if best is not None else result
        best = result
    assert best is not None
    return best


def solve(
    reqs: Sequence[ConstraintRequest],
    initial_guesses: Sequence[Tuple[Id, float]],
    config: Config = Config(),
) -> SolveOutcome:
    """Solve the constraint system. Raises ``FailureOutcome`` on definition
    errors; returns ``converged=False`` (not an error) when LM stalls.

    Mirrors the reference's doctest (``ezpz/src/lib.rs:47-87``): pin p at
    the origin, require q to be 4 away, start q near (4.39, 4.38):

    >>> import ezpz_jax as ez
    >>> ids = ez.IdGenerator()
    >>> p, q = ez.DatumPoint.new(ids), ez.DatumPoint.new(ids)
    >>> reqs = [ez.ConstraintRequest.highest_priority(c) for c in [
    ...     ez.Constraint.Fixed(p.id_x(), 0.0),
    ...     ez.Constraint.Fixed(p.id_y(), 0.0),
    ...     ez.Constraint.Distance(p, q, 4.0)]]
    >>> out = ez.solve(reqs, [(p.id_x(), 0.0), (p.id_y(), -0.02),
    ...                       (q.id_x(), 4.39), (q.id_y(), 4.38)])
    >>> out.converged
    True
    >>> qx, qy = out.final_values[2], out.final_values[3]
    >>> round((qx ** 2 + qy ** 2) ** 0.5, 6)   # |q - p| == 4
    4.0
    """
    _analysis, outcome = _solve_with_priority(reqs, initial_guesses, config, False)
    return outcome


def time_resolves(
    reqs: Sequence[ConstraintRequest],
    initial_guesses: Sequence[Tuple[Id, float]],
    config: Config = Config(),
    iters: int = 100,
    pipelined: bool = False,
) -> float:
    """Mean seconds per re-solve over ``iters`` repeats — the reference
    CLI's micro-benchmark protocol (``ezpz-cli/src/main.rs:96-100``).

    ``pipelined=False``: strictly synchronous — every solve's outcome is
    materialized on the host before the next begins, so every solve pays
    one device->host transfer.

    ``pipelined=True``: every re-solve's full host path (lint, validation,
    compile-cache lookup, dispatch) runs per iteration, but results are
    synchronized ONCE at the end and only the last outcome is materialized
    — the device-throughput complement, measuring the device instead of
    the per-solve transfer. The executed priority-tier sequence is
    recorded from one untimed cascade first (re-solves of identical input
    are deterministic, so every repeat runs the same tiers)."""
    import time

    if not pipelined:
        t0 = time.perf_counter()
        for _ in range(iters):
            solve(reqs, initial_guesses, config)
        return (time.perf_counter() - t0) / iters

    import jax

    initial_guesses = list(initial_guesses)
    entries = _resolve_entries(reqs, initial_guesses)
    priorities = sorted({req.priority for _cid, req in entries})

    # Untimed replay of the cascade to record which tier subsets execute.
    executed: List[List[Tuple[int, ConstraintRequest]]] = []
    best = None
    for curr_max in priorities:
        subset = [(cid, req) for cid, req in entries if req.priority <= curr_max]
        executed.append(subset)
        try:
            result = _solve_inner(subset, initial_guesses, config, False)
        except FailureOutcome:
            break
        if result[1].is_unsatisfied():
            break
        best = result
    del best

    t0 = time.perf_counter()
    handles = []
    for _ in range(iters):
        for subset in executed:
            packed, _system, _warnings = _dispatch_solve(
                subset, initial_guesses, config
            )
            handles.append(packed)
    jax.block_until_ready(handles)
    # Materialize one outcome so a full solve's host conversion is paid at
    # least once inside the timed region.
    np.asarray(handles[-1])
    return (time.perf_counter() - t0) / iters


def solve_analysis(
    reqs: Sequence[ConstraintRequest],
    initial_guesses: Sequence[Tuple[Id, float]],
    config: Config = Config(),
) -> SolveOutcomeFreedomAnalysis:
    """Like ``solve`` but also runs the (expensive) degrees-of-freedom
    analysis. Call on structure changes, not every value tweak."""
    analysis, outcome = _solve_with_priority(reqs, initial_guesses, config, True)
    assert analysis is not None
    return SolveOutcomeFreedomAnalysis(analysis=analysis, outcome=outcome)
