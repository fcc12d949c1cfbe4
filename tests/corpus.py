"""Shared loaders for the corpus-parametrized batch tests."""

import json
import os

import numpy as np

from .helpers import CASES_DIR

CASES = sorted(json.load(open(os.path.join(os.path.dirname(__file__),
                                           "golden_iterations.json"))))


def fixture_system(case):
    """(CompiledSystem, x0) of one textual fixture, unit weights."""
    from ezpz_jax.models.compiled import compile_system
    from ezpz_jax.textual import Problem

    txt = open(os.path.join(CASES_DIR, case, "problem.md")).read()
    cs = Problem.from_str(txt).to_constraint_system()
    x0 = np.zeros(len(cs.initial_guesses))
    for vid, val in cs.initial_guesses:
        x0[vid] = val
    # Resolve tangency sides from the guesses (data-dependent lowering).
    constraints = [r.constraint.set_from_initial_values(list(x0))
                   for r in cs.constraints]
    return compile_system(constraints, n_vars=len(x0)), x0


def three_lanes(x0, seed=0):
    """The fixture's guesses in lane 0 and two perturbed copies, so the
    vmapped loop runs lanes that finish at different trips."""
    rng = np.random.default_rng(seed)
    return np.stack([x0] + [x0 + rng.normal(0.0, 1e-3, x0.shape)
                            for _ in range(2)])
