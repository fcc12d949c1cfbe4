"""Typed errors.

Mirrors the reference's error taxonomy (``ezpz/src/error.rs``): problem
definition errors are raised/returned as data, never panics. Non-convergence
is NOT an error (it is ``SolveOutcome.converged = False``).
"""

from dataclasses import dataclass, field


class EzpzError(Exception):
    """Base class for all ezpz_jax errors."""


class NonLinearSystemError(EzpzError):
    """Errors from the core numeric solve (``ezpz/src/error.rs:35-86``)."""


@dataclass
class NotFound(NonLinearSystemError):
    id: int

    def __str__(self) -> str:
        return f"ID {self.id} not found"


@dataclass
class WrongNumberGuesses(NonLinearSystemError):
    labels: int
    guesses: int

    def __str__(self) -> str:
        return (
            "There should be exactly 1 guess per variable, but you supplied "
            f"{self.labels} variables and {self.guesses} guesses"
        )


@dataclass
class MissingGuess(NonLinearSystemError):
    """A constraint references a variable with no initial guess
    (``ezpz/src/solver.rs:142-189``)."""

    constraint_id: int
    variable: int

    def __str__(self) -> str:
        return (
            f"Constraint {self.constraint_id} references variable "
            f"{self.variable} but no such variable appears in your initial guesses."
        )


@dataclass
class EmptySystemNotAllowed(NonLinearSystemError):
    def __str__(self) -> str:
        return "Cannot solve an empty system"


@dataclass
class LinearSolveFailed(NonLinearSystemError):
    """The damped normal equations could not be factored even after lambda
    escalation (the reference surfaces faer LLT errors here)."""

    detail: str = ""

    def __str__(self) -> str:
        return f"Linear solve failed: {self.detail}"


class TextualError(EzpzError):
    """Errors from parsing/executing the textual format
    (``ezpz/src/error.rs:11-30``)."""


@dataclass
class TextualMissingGuess(TextualError):
    label: str

    def __str__(self) -> str:
        return f"No guess was given for point {self.label}"


@dataclass
class UnusedGuesses(TextualError):
    labels: list = field(default_factory=list)

    def __str__(self) -> str:
        return f"You gave a guess for points which weren't defined: {self.labels}"


@dataclass
class UndefinedPoint(TextualError):
    label: str

    def __str__(self) -> str:
        return f"You referred to the point {self.label} but it was never defined"


@dataclass
class ParseError(TextualError):
    detail: str

    def __str__(self) -> str:
        return f"Could not parse problem: {self.detail}"
