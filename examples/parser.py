#!/usr/bin/env python3
"""Parse the ezpz text format, which describes a constraint system, then
solve that system.

Mirrors the reference's ``ezpz/examples/parser.rs`` workflow:
``Problem.from_str`` -> ``to_constraint_system`` -> ``solve`` -> named
geometry lookups.

    python examples/parser.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ezpz_jax.textual import Problem

FILE = """\
# constraints
point p
point q
p.x = 0
p.y = 0
q.y = 0
vertical(p, q)

# guesses
p roughly (3, 4)
q roughly (5, 6)
"""


def main() -> None:
    problem = Problem.from_str(FILE)
    system = problem.to_constraint_system()
    solution = system.solve()

    assert not solution.unsatisfied
    p = solution.get_point("p")
    q = solution.get_point("q")
    print(f"p = ({p.x:.6f}, {p.y:.6f})")
    print(f"q = ({q.x:.6f}, {q.y:.6f})")
    # p is pinned to the origin; vertical(p, q) + q.y = 0 puts q there too.
    assert abs(p.x) < 1e-5 and abs(p.y) < 1e-5
    assert abs(q.x) < 1e-5 and abs(q.y) < 1e-5


if __name__ == "__main__":
    main()
