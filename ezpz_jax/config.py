"""Solver configuration (``ezpz/src/solver.rs:33-81``)."""

from __future__ import annotations

from dataclasses import dataclass, replace

# Initial Levenberg-Marquardt damping (``solver.rs:23``).
DEFAULT_INITIAL_LAMBDA = 1e-9
# Adaptive damping multipliers (``solver/newton.rs:15-16``).
LM_LAMBDA_INCR = 10.0
LM_LAMBDA_DECR = 0.1


@dataclass(frozen=True)
class Config:
    """How to solve a system. Defaults match the reference exactly
    (``solver.rs:72-80``).

    >>> Config().max_iterations
    35
    >>> Config().residual_tolerance
    1e-08
    >>> cfg = Config().with_max_iterations(10).with_initial_lambda(1e-6)
    >>> cfg.max_iterations, cfg.initial_lambda
    (10, 1e-06)
    >>> Config().with_step_tolerance(1e-10).step_tolerance
    1e-10

    ``precision`` is an extension (the reference is f64-only): "f64"
    (default) is the reference-exact path — required wherever
    iteration-count parity matters; "mixed" runs the LM loop in f32 with
    f64-residual refinement (see ``solver.solve_lm_mixed``) — same 1e-8
    f64 residual verification, iteration counts NOT comparable to the
    reference's.

    >>> Config().with_precision("mixed").precision
    'mixed'
    """

    max_iterations: int = 35
    residual_tolerance: float = 1e-8
    step_tolerance: float = 1e-12
    initial_lambda: float = DEFAULT_INITIAL_LAMBDA
    precision: str = "f64"

    def with_max_iterations(self, value: int) -> "Config":
        return replace(self, max_iterations=value)

    def with_convergence_tolerance(self, value: float) -> "Config":
        return replace(self, residual_tolerance=value)

    def with_step_tolerance(self, value: float) -> "Config":
        return replace(self, step_tolerance=value)

    def with_initial_lambda(self, value: float) -> "Config":
        return replace(self, initial_lambda=value)

    def with_precision(self, value: str) -> "Config":
        if value not in ("f64", "mixed"):
            raise ValueError(f"precision must be 'f64' or 'mixed', got {value!r}")
        return replace(self, precision=value)
