"""Mixed circle + arc variable layout regression.

The reference has a LATENT BUG here: ``geometry_variables.rs:92`` computes
arc variable offsets ignoring circle variables while the executor's output
path includes them (``executor.rs:549``), so a problem declaring BOTH a
circle and an arc would mis-index on output. SURVEY.md section 7 "hard
parts" requires this framework to define one consistent layout and test the
mixed case explicitly — which the reference's own test corpus never does.
"""

import math

from ezpz_jax.textual import Problem

PROBLEM = """\
# constraints
point p
circle c
arc a
radius(c, 2.5)
c.center = (1, 1)
a.center.x = 10
a.center.y = 0
arc_radius(a, 5)
p = (0, 7)

# guesses
p roughly (0.2, 6.5)
c.center roughly (0.9, 1.2)
c.radius roughly 2
a.center roughly (10.1, 0.3)
a.a roughly (10, 5.2)
a.b roughly (15.2, 0)
"""


def test_circle_and_arc_outputs_correctly_indexed():
    out = Problem.from_str(PROBLEM).to_constraint_system().solve()
    assert out.is_satisfied()

    p = out.get_point("p")
    assert (round(p.x, 4), round(p.y, 4)) == (0.0, 7.0)

    c = out.get_circle("c")
    assert (round(c.center.x, 4), round(c.center.y, 4)) == (1.0, 1.0)
    assert round(c.radius, 4) == 2.5

    a = out.get_arc("a")
    assert (round(a.center.x, 4), round(a.center.y, 4)) == (10.0, 0.0)
    # Both arc endpoints sit 5 away from the center (arc_radius).
    for end in (a.a, a.b):
        r = math.hypot(end.x - a.center.x, end.y - a.center.y)
        assert abs(r - 5.0) < 1e-4
    # The endpoints stayed near their guesses (top / right of the center),
    # which is only true if arc variables were not shifted by the circle's.
    assert a.a.y > 4.0 and abs(a.a.x - 10.0) < 1.0
    assert a.b.x > 14.0 and abs(a.b.y) < 1.0


def test_arc_before_circle_label_resolution():
    """Declaration order circle-after-... the layout is points, circles,
    arcs regardless of declaration interleaving; swap declaration order and
    re-check."""
    txt = PROBLEM.replace("circle c\narc a", "arc a\ncircle c")
    out = Problem.from_str(txt).to_constraint_system().solve()
    assert out.is_satisfied()
    c = out.get_circle("c")
    assert round(c.radius, 4) == 2.5
    a = out.get_arc("a")
    assert (round(a.center.x, 4), round(a.center.y, 4)) == (10.0, 0.0)
