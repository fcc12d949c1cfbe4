"""Textual problem format: parser and executor.

The format (``ezpz/src/textual/``):

    # constraints
    point p
    point q
    p = (0, 0)
    vertical(p, q)

    # guesses
    p roughly (3, 4)
    q roughly (5, 6)

In this build the executor is a *trace-to-arrays compiler*: it
resolves labels to variable ids and produces ``ConstraintRequest``s that the
array compiler groups into padded per-type index/param arrays.
"""

from .problem import Problem, Label, PointGuess, ScalarGuess
from .executor import ConstraintSystem, Outcome, OutcomeAnalysis

__all__ = [
    "Problem",
    "Label",
    "PointGuess",
    "ScalarGuess",
    "ConstraintSystem",
    "Outcome",
    "OutcomeAnalysis",
]
