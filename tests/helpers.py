"""Shared test helpers mirroring ezpz/src/tests.rs:17-36,1160-1202."""

import math
import os

CASES_DIR = os.path.join(os.path.dirname(__file__), "cases")
EPSILON = 1e-4


def run(test_case, config=None):
    from ezpz_jax.config import Config
    from ezpz_jax.textual import Problem

    txt = open(os.path.join(CASES_DIR, test_case, "problem.md")).read()
    problem = Problem.from_str(txt)
    system = problem.to_constraint_system()
    return system.solve_with_config_analysis(config or Config())


def assert_points_eq(l, r):
    dist = math.hypot(l.x - r[0] if isinstance(r, tuple) else l.x - r.x,
                      l.y - r[1] if isinstance(r, tuple) else l.y - r.y)
    assert dist < EPSILON, f"LHS was {l}, RHS was {r}, dist was {dist}"


def assert_nearly_eq(l, r):
    diff = abs(l - r)
    assert diff < EPSILON, f"LHS was {l}, RHS was {r}, difference was {diff}"
