"""Golden end-to-end fixture tests.

Mirrors the reference's fixture-driven tests (ezpz/src/tests.rs) one-to-one:
same textual inputs, same expected coordinates (1e-4), same underconstrained
variable id lists, same satisfaction outcomes.
"""

import json
import math
import os

import pytest

from .helpers import run, assert_points_eq, assert_nearly_eq

# Exact LM iteration counts for every fixture on the pure-f64 path,
# recorded once and committed as data. The reference pins iteration counts
# as convergence regressions (tests.rs:1126, tests.rs:1600-1606); this
# extends that discipline to the whole corpus, so any drift in the lambda
# schedule, accept rule, or convergence checks fails here even when final
# coordinates still land within 1e-4. Cross-check: massive_parallel_system
# = 2 iterations, matching the reference's published number (README.md:40).
_GOLDEN_ITERATIONS = json.load(
    open(os.path.join(os.path.dirname(__file__), "golden_iterations.json"))
)


@pytest.mark.parametrize("case", sorted(_GOLDEN_ITERATIONS))
def test_iteration_count_pinned(case):
    solved = run(case)
    assert solved.outcome.converged
    assert solved.outcome.iterations == _GOLDEN_ITERATIONS[case], (
        f"{case}: LM took {solved.outcome.iterations} iterations, "
        f"golden value is {_GOLDEN_ITERATIONS[case]} — the lambda schedule "
        f"or accept rule drifted"
    )


def test_golden_iterations_covers_whole_corpus():
    """Every fixture directory must have a pinned count (new fixtures must
    be recorded, not silently skipped)."""
    from .helpers import CASES_DIR

    dirs = sorted(
        d for d in os.listdir(CASES_DIR)
        if os.path.isdir(os.path.join(CASES_DIR, d))
    )
    assert dirs == sorted(_GOLDEN_ITERATIONS)


def test_coincident():
    solved = run("coincident")
    assert solved.is_satisfied()
    assert not solved.analysis.is_underconstrained()
    assert_points_eq(solved.get_point("p"), (3.0, 3.0))
    assert_points_eq(solved.get_point("q"), (3.0, 3.0))


def test_symmetric():
    solved = run("symmetric")
    assert solved.is_satisfied()
    assert not solved.analysis.is_underconstrained()
    assert_points_eq(solved.get_point("p"), (0.0, 0.0))
    assert_points_eq(solved.get_point("q"), (2.0, 2.0))
    assert_points_eq(solved.get_point("a"), (0.5, 0.4))
    assert_points_eq(solved.get_point("b"), (0.4, 0.5))


def test_perpdist():
    solved = run("perpdist")
    assert solved.is_satisfied()
    assert_points_eq(solved.get_point("p"), (0.0, 0.0))
    assert_points_eq(solved.get_point("q"), (2.0, 3.0))
    assert_points_eq(
        solved.get_point("a"), (0.10055560181546289, 1.9536090405127489)
    )
    assert solved.analysis.is_underconstrained()
    assert solved.analysis.underconstrained() == [4, 5]


def test_perpdist_negative():
    solved = run("perpdist_negative")
    assert solved.is_satisfied()
    assert solved.analysis.is_underconstrained()
    assert solved.analysis.underconstrained() == [4, 5]
    assert_points_eq(solved.get_point("p"), (0.0, 0.0))
    assert_points_eq(solved.get_point("q"), (2.0, 3.0))
    assert_points_eq(
        solved.get_point("a"), (1.5192717280306194, 0.476131954511605)
    )


def test_midpoint():
    solved = run("midpoint")
    assert solved.is_satisfied()
    assert not solved.analysis.is_underconstrained()
    assert_points_eq(solved.get_point("p"), (0.0, 0.0))
    assert_points_eq(solved.get_point("q"), (2.0, 3.0))
    assert_points_eq(solved.get_point("m"), (1.0, 1.5))


def test_underconstrained():
    solved = run("underconstrained")
    assert solved.analysis.is_underconstrained()
    assert solved.is_satisfied()
    assert solved.analysis.underconstrained() == [0, 1]
    assert_points_eq(solved.get_point("p"), (1.0, 1.0))
    assert_points_eq(solved.get_point("q"), (0.0, 0.0))


def test_tiny():
    solved = run("tiny")
    assert solved.is_satisfied()
    assert not solved.analysis.is_underconstrained()
    assert_points_eq(solved.get_point("p"), (0.0, 0.0))
    assert_points_eq(solved.get_point("q"), (0.0, 0.0))


def test_inconsistent():
    solved = run("inconsistent")
    assert not solved.is_satisfied()
    assert not solved.analysis.is_underconstrained()
    assert_points_eq(solved.get_point("o"), (0.0, 0.0))
    # Midway between the two inconsistent requirement points.
    assert_points_eq(solved.get_point("p"), (2.5, 2.5))


def test_circle():
    solved = run("circle")
    assert solved.is_satisfied()
    assert not solved.analysis.is_underconstrained()
    assert_points_eq(solved.get_point("p"), (5.0, 5.0))
    circle_a = solved.get_circle("a")
    assert_nearly_eq(circle_a.radius, 3.4)
    assert_points_eq(circle_a.center, (0.1, 0.2))


def test_circle_center():
    solved = run("circle_center")
    assert not solved.analysis.is_underconstrained()
    assert solved.is_satisfied()
    circle_a = solved.get_circle("a")
    assert_nearly_eq(circle_a.radius, 1.0)
    assert_points_eq(circle_a.center, (0.0, 0.0))


def test_circle_tangent():
    solved = run("circle_tangent")
    assert solved.is_satisfied()
    assert not solved.analysis.is_underconstrained()
    assert_points_eq(solved.get_point("p"), (0.0, 3.0))
    assert_points_eq(solved.get_point("q"), (5.0, 3.0))
    circle_a = solved.get_circle("a")
    assert_nearly_eq(circle_a.center.y, 1.5)
    assert_nearly_eq(circle_a.radius, 1.5)


def test_circle_tangent_other_dir():
    solved = run("circle_tangent_other_dir")
    assert solved.is_satisfied()
    assert not solved.analysis.is_underconstrained()
    assert_points_eq(solved.get_point("p"), (0.0, 3.0))
    assert_points_eq(solved.get_point("q"), (5.0, 3.0))
    circle_a = solved.get_circle("a")
    assert_nearly_eq(circle_a.center.y, 1.5)
    assert_nearly_eq(circle_a.radius, 1.5)


def test_two_rectangles():
    solved = run("two_rectangles")
    assert solved.is_satisfied()
    assert not solved.analysis.is_underconstrained()
    assert_points_eq(solved.get_point("p0"), (1.0, 1.0))
    assert_points_eq(solved.get_point("p1"), (5.0, 1.0))
    assert_points_eq(solved.get_point("p2"), (5.0, 4.0))
    assert_points_eq(solved.get_point("p3"), (1.0, 4.0))
    assert_points_eq(solved.get_point("p4"), (2.0, 2.0))
    assert_points_eq(solved.get_point("p5"), (6.0, 2.0))
    assert_points_eq(solved.get_point("p6"), (6.0, 6.0))
    assert_points_eq(solved.get_point("p7"), (2.0, 6.0))


@pytest.mark.parametrize("case", ["angle_parallel", "angle_parallel_manual"])
def test_angle_constraints(case):
    solved = run(case)
    assert solved.is_satisfied()
    assert not solved.analysis.is_underconstrained()
    assert_points_eq(solved.get_point("p0"), (0.0, 0.0))
    assert_points_eq(solved.get_point("p1"), (4.0, 4.0))
    assert_points_eq(solved.get_point("p2"), (0.0, 0.0))
    assert_points_eq(solved.get_point("p3"), (4.0, 4.0))


def test_perpendicular():
    solved = run("perpendicular")
    assert solved.is_satisfied()
    assert not solved.analysis.is_underconstrained()
    assert_points_eq(solved.get_point("p0"), (0.0, 0.0))
    assert_points_eq(solved.get_point("p1"), (0.0, 4.0))
    assert_points_eq(solved.get_point("p2"), (0.0, 0.0))
    assert_points_eq(solved.get_point("p3"), (4.0, 0.0))


def test_nonsquare():
    solved = run("nonsquare")
    assert solved.is_satisfied()
    assert not solved.analysis.is_underconstrained()
    assert_points_eq(solved.get_point("p"), (0.0, 0.0))
    assert_points_eq(solved.get_point("q"), (0.0, 0.0))


def test_square():
    solved = run("square")
    assert solved.is_satisfied()
    assert not solved.analysis.is_underconstrained()
    a, b = solved.get_point("a"), solved.get_point("b")
    c, d = solved.get_point("c"), solved.get_point("d")
    assert_nearly_eq(a.y - c.y, b.y - d.y)
    assert_nearly_eq(a.x - c.x, d.x - b.x)


def test_parallelogram():
    solved = run("parallelogram")
    assert solved.analysis.is_underconstrained()
    assert solved.analysis.underconstrained() == [4, 5, 6, 7]
    a, b = solved.get_point("a"), solved.get_point("b")
    c, d = solved.get_point("c"), solved.get_point("d")
    assert_nearly_eq(a.y - c.y, b.y - d.y)
    assert_nearly_eq(a.x - c.x, b.x - d.x)


def test_underdetermined_lines():
    solved = run("underdetermined_lines")
    assert solved.analysis.is_underconstrained()
    assert solved.analysis.underconstrained() == [5]
    assert solved.is_satisfied()
    assert_points_eq(solved.get_point("p0"), (0.0, 0.0))
    assert_points_eq(solved.get_point("p1"), (4.0, 0.0))
    assert_points_eq(solved.get_point("p2"), (4.0, 4.0))


def test_arc_radius():
    solved = run("arc_radius")
    assert solved.is_satisfied()
    assert solved.analysis.is_underconstrained()
    assert solved.analysis.underconstrained() == [0, 1, 2, 3, 4, 5]
    arc = solved.get_arc("a")
    assert_points_eq(arc.center, (0.0, 0.0))
    assert_nearly_eq(5.0, math.hypot(arc.a.x, arc.a.y))
    assert_nearly_eq(5.0, math.hypot(arc.b.x, arc.b.y))


def test_parc_coincident():
    solved = run("parc_coincident")
    assert solved.is_satisfied()
    assert solved.analysis.is_underconstrained()
    arc = solved.get_arc("a")
    assert_points_eq(arc.center, (0.0, 0.0))
    assert_nearly_eq(5.0, math.hypot(arc.a.x, arc.a.y))
    assert_nearly_eq(5.0, math.hypot(arc.b.x, arc.b.y))
    point = solved.get_point("p")
    assert_nearly_eq(5.0, math.hypot(point.x - arc.center.x, point.y - arc.center.y))


def test_arc_equidistant():
    solved = run("arc_equidistant")
    assert solved.is_satisfied()
    assert solved.analysis.is_underconstrained()
    assert solved.analysis.underconstrained() == [0, 1, 2, 3, 4, 5]
    arc = solved.get_arc("a")
    assert_points_eq(arc.center, (0.0, 0.0))
    assert_nearly_eq(
        math.hypot(arc.a.x - arc.center.x, arc.a.y - arc.center.y),
        math.hypot(arc.b.x - arc.center.x, arc.b.y - arc.center.y),
    )


def test_chamfer_square():
    solved = run("chamfer_square")
    assert solved.is_satisfied()
    assert not solved.analysis.is_underconstrained()
    assert_points_eq(solved.get_point("a"), (0.0, 40.0))
    assert_points_eq(solved.get_point("b"), (30.0, 40.0))
    assert_points_eq(solved.get_point("c"), (40.0, 30.0))
    assert_points_eq(solved.get_point("d"), (40.0, 0.0))
    assert_points_eq(solved.get_point("e"), (0.0, 0.0))


def test_arc_length():
    solved = run("arc_length")
    assert solved.is_satisfied()


def test_arc_center_point_coincident():
    """Stability+effectiveness of PointArcCoincident (tests.rs:1399-1503)."""
    solved = run("arc_center_point_coincident")

    initial_line4_start = (-1.16, -2.63)
    solved_line4_start = solved.get_point("line4start")
    arc = solved.get_arc("arc1")

    arc_radius = math.hypot(arc.center.x - arc.a.x, arc.center.y - arc.a.y)
    point_to_center = math.hypot(
        solved_line4_start.x - arc.center.x, solved_line4_start.y - arc.center.y
    )
    assert abs(point_to_center - arc_radius) < 0.01

    # Point must end up within the CCW angular range.
    cx, cy = arc.center.x, arc.center.y
    px, py = solved_line4_start.x, solved_line4_start.y
    start_cross = (arc.a.x - cx) * (cy - py) - (arc.a.y - cy) * (cx - px)
    end_cross = (arc.b.x - cx) * (cy - py) - (arc.b.y - cy) * (cx - px)
    assert start_cross < 0.01
    assert end_cross < 1e-6

    # Large initial angular violation -> meaningful movement.
    movement = math.hypot(
        solved_line4_start.x - initial_line4_start[0],
        solved_line4_start.y - initial_line4_start[1],
    )
    initial_start_cross = (2.25 - 0.55) * (-3.31 + 2.63) - (-3.99 + 3.31) * (0.55 + 1.16)
    if initial_start_cross > 0.1:
        assert movement > arc_radius * 0.3


def test_point_basically_already_on_arc_stability():
    """Adding point_arc_coincident must not cause a dramatic jump when the
    point is already basically on the arc (tests.rs:1294-1383)."""
    solved_with = run("arc_line_coincident_bug")
    initial_line4_start = (-2.32, -2.96)
    initial_arc_center = (1.06, -3.26)
    initial_arc_a = (-1.44, -0.99)

    initial_arc_radius = math.hypot(
        initial_arc_center[0] - initial_arc_a[0], initial_arc_center[1] - initial_arc_a[1]
    )
    initial_dist_center = math.hypot(
        initial_line4_start[0] - initial_arc_center[0],
        initial_line4_start[1] - initial_arc_center[1],
    )
    initial_distance_from_arc = abs(initial_dist_center - initial_arc_radius)
    assert initial_distance_from_arc < 0.5

    s = solved_with.get_point("line4start")
    change = math.hypot(s.x - initial_line4_start[0], s.y - initial_line4_start[1])
    assert change <= initial_distance_from_arc * 10.0


def test_mixed_entity_layout_and_extraction():
    """Variable layout + result extraction with a point, TWO circles, and
    an arc in one problem (no corpus fixture mixes multiples of each).
    Pins the layout constants (2/3/6 vars per point/circle/arc) and the
    extraction base offsets — with a single circle or no arcs, a wrong
    stride or a sign-flipped offset is self-consistently invisible
    (mutation-found)."""
    from ezpz_jax.textual import Problem

    txt = """# constraints
point p
circle a
circle b
arc k
arc m
p = (1, 2)
radius(a, 3.0)
a.center = (0, 0)
radius(b, 0.5)
b.center = (4, 4)
k.center.x = 10
k.center.y = 0
m.center.x = -7
m.center.y = 1

# guesses
p roughly (1.2, 1.9)
a.center roughly (0.1, 0.2)
a.radius roughly 2.5
b.center roughly (4.1, 3.8)
b.radius roughly 0.4
k.center roughly (10.1, 0.1)
k.a roughly (10, 2)
k.b roughly (12, 0)
m.center roughly (-7.2, 1.1)
m.a roughly (-7, 3)
m.b roughly (-5, 1)
"""
    problem = Problem.from_str(txt)
    system = problem.to_constraint_system()
    # Layout: 1 point (2) + 2 circles (3 each) + 1 arc (6) = 14 variables.
    assert len(system.initial_guesses) == 2 + 2 * 3 + 2 * 6
    # The CLI timing protocol is 100 re-solves (ezpz-cli/src/main.rs:163).
    import inspect
    assert inspect.signature(system.time_resolves).parameters["iters"].default == 100

    solved = system.solve_with_config_analysis()
    assert solved.is_satisfied()
    assert_points_eq(solved.get_point("p"), (1.0, 2.0))
    circle_a = solved.get_circle("a")
    assert_nearly_eq(circle_a.radius, 3.0)
    assert_points_eq(circle_a.center, (0.0, 0.0))
    circle_b = solved.get_circle("b")       # i=1: stride + offset visible
    assert_nearly_eq(circle_b.radius, 0.5)
    assert_points_eq(circle_b.center, (4.0, 4.0))
    arc_k = solved.get_arc("k")             # behind 2 circles: base offset
    assert_points_eq(arc_k.center, (10.0, 0.0))
    # Arc endpoints keep their (unconstrained) guess neighborhoods — they
    # exist and extract from the right slots.
    assert abs(arc_k.a.x - 10) < 1.0 and abs(arc_k.b.x - 12) < 1.0
    arc_m = solved.get_arc("m")             # i=1: arc stride visible
    assert_points_eq(arc_m.center, (-7.0, 1.0))
    assert abs(arc_m.a.x - (-7)) < 1.0 and abs(arc_m.b.x - (-5)) < 1.0
