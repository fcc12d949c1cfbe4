"""API-level behavior tests mirroring ezpz/src/tests.rs (non-fixture tests):
priorities, weights, tangency side inference, arc-length cases, and the
reference's exact pinned LM iteration counts."""

import math

import pytest

import ezpz_jax as ez
from ezpz_jax import (
    Angle,
    AngleKind,
    CircleSide,
    Config,
    Constraint,
    ConstraintRequest,
    DatumCircle,
    DatumCircularArc,
    DatumDistance,
    DatumLineSegment,
    DatumPoint,
    FailureOutcome,
    IdGenerator,
    LineSide,
)
from ezpz_jax.utils.warnings import WarningKind

from .helpers import assert_nearly_eq

PI = math.pi


def hp(c):
    return ConstraintRequest.highest_priority(c)


def test_empty():
    with pytest.raises(FailureOutcome):
        ez.solve([hp(Constraint.Fixed(0, 0.0))], [], Config())


def test_returns_best_satisfied_solution():
    constraints = [
        ConstraintRequest.new(Constraint.Fixed(0, 0.0), 0),
        ConstraintRequest.new(Constraint.Fixed(0, 1.0), 1),
        ConstraintRequest.new(Constraint.Fixed(0, 2.0), 1),
    ]
    solved = ez.solve_analysis(constraints, [(0, 0.5)], Config())
    assert solved.outcome.is_satisfied()
    assert solved.outcome.priority_solved == 0


def test_initials_become_finals_if_no_constraints():
    solved = ez.solve_analysis([], [(0, 0.5)], Config())
    assert solved.outcome.is_satisfied()
    assert solved.outcome.final_values == [0.5]


def test_priority_solver_reports_original_indices():
    constraints = [
        ConstraintRequest.new(Constraint.Fixed(0, 0.0), 1),
        ConstraintRequest.new(Constraint.Fixed(0, 1.0), 0),
        ConstraintRequest.new(Constraint.Fixed(0, 2.0), 0),
    ]
    solved = ez.solve_analysis(constraints, [(0, 0.5)], Config())
    assert solved.outcome.unsatisfied == [1, 2]
    assert solved.outcome.priority_solved == 0


def test_too_many_variables():
    with pytest.raises(FailureOutcome) as exc:
        ez.solve_analysis([hp(Constraint.Fixed(0, 0.0))], [], Config())
    err = exc.value.error
    assert err.constraint_id == 0 and err.variable == 0


def test_weight_biases_inconsistent_solution():
    constraints = [
        hp(Constraint.Fixed(0, 0.0)),
        hp(Constraint.Fixed(0, 100.0)).with_weight(100.0),
    ]
    solved = ez.solve(constraints, [(0, 50.0)], Config())
    assert solved.final_values[0] > 99.0

    baseline = [hp(Constraint.Fixed(0, 0.0)), hp(Constraint.Fixed(0, 100.0))]
    baseline_solved = ez.solve(baseline, [(0, 50.0)], Config())
    assert_nearly_eq(baseline_solved.final_values[0], 50.0)


def _tangent_setup():
    ids = IdGenerator()
    p0 = DatumPoint.new(ids)
    p1 = DatumPoint.new(ids)
    center = DatumPoint.new(ids)
    radius = DatumDistance(ids.next_id())
    line = DatumLineSegment(p0, p1)
    circle = DatumCircle(center=center, radius=radius)
    return p0, p1, center, radius, line, circle


@pytest.mark.parametrize(
    "side,center_y_guess,expected_center_y",
    [
        (LineSide.Left, 1.5, 4.5),
        (LineSide.Right, 4.5, 1.5),
        (LineSide.Undefined, 4.5, 4.5),
        (LineSide.Undefined, 1.5, 1.5),
    ],
)
def test_line_tangent_sides(side, center_y_guess, expected_center_y):
    """tests.rs:342-487 — explicit and inferred tangency sides."""
    p0, p1, center, radius, line, circle = _tangent_setup()
    constraints = [
        hp(Constraint.Fixed(p0.id_y(), 3.0)),
        hp(Constraint.Fixed(p1.id_y(), 3.0)),
        hp(Constraint.CircleRadius(circle, 1.5)),
        hp(Constraint.LineTangentToCircle(line, circle, side)),
    ]
    guesses = [
        (p0.id_x(), 0.0),
        (p0.id_y(), 3.0),
        (p1.id_x(), 5.0),
        (p1.id_y(), 3.0),
        (center.id_x(), 2.0),
        (center.id_y(), center_y_guess),
        (radius.id, 1.5),
    ]
    solved = ez.solve(constraints, guesses, Config())
    assert solved.is_satisfied()
    c = solved.final_value_circle(circle)
    assert_nearly_eq(c.center.y, expected_center_y)
    assert_nearly_eq(c.radius, 1.5)


@pytest.mark.parametrize(
    "ra,rb,bx_guess,expected_center_dist",
    [(2.0, 3.0, 4.0, 5.0), (5.0, 2.0, 1.0, 3.0)],
)
def test_circle_tangent_inferred(ra, rb, bx_guess, expected_center_dist):
    """tests.rs:490-561 — exterior/interior circle tangency inference."""
    ids = IdGenerator()
    circle_a = DatumCircle(center=DatumPoint.new(ids), radius=DatumDistance(ids.next_id()))
    circle_b = DatumCircle(center=DatumPoint.new(ids), radius=DatumDistance(ids.next_id()))
    guesses = [
        (circle_a.center.id_x(), 0.0),
        (circle_a.center.id_y(), 0.0),
        (circle_a.radius.id, ra),
        (circle_b.center.id_x(), bx_guess),
        (circle_b.center.id_y(), 0.0),
        (circle_b.radius.id, rb),
    ]
    constraints = [
        hp(Constraint.Fixed(circle_a.radius.id, ra)),
        hp(Constraint.Fixed(circle_b.radius.id, rb)),
        hp(Constraint.CircleTangentToCircle(circle_a, circle_b, CircleSide.Undefined)),
    ]
    outcome = ez.solve(constraints, guesses, Config())
    assert outcome.is_satisfied()
    ca = outcome.final_value_point(circle_a.center)
    cb = outcome.final_value_point(circle_b.center)
    assert_nearly_eq(ca.euclidean_distance(cb), expected_center_dist)


def test_trim_arc2_left_side_arc1_should_remain_fixed():
    """tests.rs:764-897 — PointArcCoincident must not disturb a fully fixed arc."""
    ids = IdGenerator()
    arc1 = DatumCircularArc(
        center=DatumPoint.new(ids), start=DatumPoint.new(ids), end=DatumPoint.new(ids)
    )
    arc2 = DatumCircularArc(
        center=DatumPoint.new(ids), start=DatumPoint.new(ids), end=DatumPoint.new(ids)
    )
    guesses = [
        (arc1.center.id_x(), 30.0), (arc1.center.id_y(), 0.0),
        (arc1.start.id_x(), 0.0), (arc1.start.id_y(), 5.0),
        (arc1.end.id_x(), 0.0), (arc1.end.id_y(), -5.0),
        (arc2.center.id_x(), 0.0), (arc2.center.id_y(), -30.0),
        (arc2.start.id_x(), 5.0), (arc2.start.id_y(), 0.0),
        (arc2.end.id_x(), -5.0), (arc2.end.id_y(), 0.0),
    ]
    constraints = [
        hp(Constraint.Arc(arc1)),
        hp(Constraint.Arc(arc2)),
        hp(Constraint.Fixed(arc1.center.id_x(), 30.0)),
        hp(Constraint.Fixed(arc1.center.id_y(), 0.0)),
        hp(Constraint.Fixed(arc1.start.id_x(), 0.0)),
        hp(Constraint.Fixed(arc1.start.id_y(), 5.0)),
        hp(Constraint.Fixed(arc1.end.id_x(), 0.0)),
        hp(Constraint.Fixed(arc1.end.id_y(), -5.0)),
        hp(Constraint.Fixed(arc2.center.id_x(), 0.0)),
        hp(Constraint.Fixed(arc2.center.id_y(), -30.0)),
        hp(Constraint.Fixed(arc2.start.id_x(), 5.0)),
        hp(Constraint.Fixed(arc2.start.id_y(), 0.0)),
        hp(Constraint.PointArcCoincident(arc2, arc2.end)),
        hp(Constraint.PointArcCoincident(arc1, arc2.end)),
    ]
    outcome = ez.solve(constraints, guesses, Config())
    assert outcome.is_satisfied()
    fv = outcome.final_values
    assert_nearly_eq(fv[arc1.center.id_x()], 30.0)
    assert_nearly_eq(fv[arc1.center.id_y()], 0.0)
    assert_nearly_eq(fv[arc1.start.id_x()], 0.0)
    assert_nearly_eq(fv[arc1.start.id_y()], 5.0)
    assert_nearly_eq(fv[arc1.end.id_x()], 0.0)
    assert_nearly_eq(fv[arc1.end.id_y()], -5.0)


def _solve_arc_length_case(cx, cy, r, start_rad, desired_len, end_guess):
    ids = IdGenerator()
    arc = DatumCircularArc(
        center=DatumPoint.new(ids), start=DatumPoint.new(ids), end=DatumPoint.new(ids)
    )
    sx = cx + math.cos(start_rad) * r
    sy = cy + math.sin(start_rad) * r
    guesses = [
        (arc.center.id_x(), cx), (arc.center.id_y(), cy),
        (arc.start.id_x(), sx), (arc.start.id_y(), sy),
        (arc.end.id_x(), end_guess[0]), (arc.end.id_y(), end_guess[1]),
    ]
    constraints = [
        hp(Constraint.Arc(arc)),
        hp(Constraint.Fixed(arc.center.id_x(), cx)),
        hp(Constraint.Fixed(arc.center.id_y(), cy)),
        hp(Constraint.Fixed(arc.start.id_x(), sx)),
        hp(Constraint.Fixed(arc.start.id_y(), sy)),
        hp(Constraint.ArcLength(arc, desired_len)),
    ]
    outcome = ez.solve(constraints, guesses, Config())
    return outcome, arc


@pytest.mark.parametrize(
    "cx,cy,r,start_rad,desired_len,end_guess",
    [
        (0.0, 0.0, 1.0, 0.0, 1.5 * PI, (0.0, -1.0)),
        (-2.0, 3.0, 5.0, 0.25 * PI, 1.0e-3, None),
        (1.0, -1.0, 2.5, 0.0, 2.0 * PI * 2.5 - 1.0e-3, None),
    ],
)
def test_arc_length_cases(cx, cy, r, start_rad, desired_len, end_guess):
    """tests.rs:945-1048 — CCW over pi, near zero, near full circle."""
    if end_guess is None:
        delta = 1.0e-2 if desired_len < 1.0 else -1.0e-2
        end_guess = (
            cx + math.cos(start_rad + delta if desired_len < 1.0 else delta) * r,
            cy + math.sin(start_rad + delta if desired_len < 1.0 else delta) * r,
        )
    outcome, arc = _solve_arc_length_case(cx, cy, r, start_rad, desired_len, end_guess)
    assert outcome.is_satisfied()
    ex = outcome.final_values[arc.end.id_x()]
    ey = outcome.final_values[arc.end.id_y()]
    assert_nearly_eq(math.hypot(ex - cx, ey - cy), r)
    end_rad = math.atan2(ey - cy, ex - cx) % (2 * PI)
    ccw_delta = (end_rad - start_rad) % (2 * PI)
    assert_nearly_eq(r * ccw_delta, desired_len)


def test_arc_length_degenerate_warns():
    ids = IdGenerator()
    arc = DatumCircularArc(
        center=DatumPoint.new(ids), start=DatumPoint.new(ids), end=DatumPoint.new(ids)
    )
    guesses = [
        (arc.center.id_x(), 0.0), (arc.center.id_y(), 0.0),
        (arc.start.id_x(), 0.0), (arc.start.id_y(), 0.0),
        (arc.end.id_x(), 1.0), (arc.end.id_y(), 0.0),
    ]
    constraints = [
        hp(Constraint.Fixed(arc.center.id_x(), 0.0)),
        hp(Constraint.Fixed(arc.center.id_y(), 0.0)),
        hp(Constraint.Fixed(arc.start.id_x(), 0.0)),
        hp(Constraint.Fixed(arc.start.id_y(), 0.0)),
        hp(Constraint.ArcLength(arc, 1.0)),
    ]
    outcome = ez.solve(constraints, guesses, Config())
    assert any(w.content is WarningKind.DEGENERATE for w in outcome.warnings)


def test_strange_nonconvergence_iteration_count():
    """tests.rs:1090-1127 — pinned at exactly 2 LM iterations."""
    p = DatumPoint(0, 1)
    q = DatumPoint(2, 3)
    r = DatumPoint(4, 5)
    s = DatumPoint(6, 7)
    t = DatumPoint(8, 9)
    requests = [
        hp(Constraint.Fixed(0, 0.0)),
        hp(Constraint.Fixed(1, 0.0)),
        hp(Constraint.PointsCoincident(r, s)),
        hp(Constraint.PointsCoincident(q, p)),
        hp(Constraint.LinesEqualLength(DatumLineSegment(q, r), DatumLineSegment(s, t))),
    ]
    guesses = [
        (0, 0.0), (1, -0.02), (2, -3.39), (3, -0.38), (4, -2.76),
        (5, 4.83), (6, -1.54), (7, 5.21), (8, -1.15), (9, 2.75),
    ]
    outcome = ez.solve(requests, guesses, Config().with_max_iterations(31))
    assert outcome.iterations == 2


@pytest.mark.parametrize(
    "points,angle,expected_iters",
    [
        ([[0, 0], [1, 0], [0, 0], [0, 2]], 0.5 * PI, 0),
        ([[0, 0], [1, 0], [0, 0], [0, 2]], -0.5 * PI, 0),
        ([[0, 0], [1, 0], [0, 0], [2, 0]], 0.0, 0),
        ([[0, 0], [1, 0], [0, 0], [2, 0]], PI, 0),
        ([[0, 0], [-1, 0], [0, 0], [2, 0]], 0.0, 0),
        ([[0, 0], [-1, 0], [0, 0], [2, 0]], PI, 0),
        ([[0, 0], [1, 0], [0, 0], [0, 2]], 0.0, 4),
        ([[0, 0], [1, 0], [0, 0], [0, 2]], PI, 4),
        ([[0, 0], [0, 1], [0, 0], [0, 2]], 0.5 * PI, 4),
        ([[0, 0], [0, 1], [0, 0], [0, 2]], -0.5 * PI, 4),
    ],
)
def test_lines_at_angle_isolated(points, angle, expected_iters):
    """tests.rs:1505-1607 — pinned iteration counts for LinesAtAngle."""
    line0 = DatumLineSegment(DatumPoint(0, 1), DatumPoint(2, 3))
    line1 = DatumLineSegment(DatumPoint(4, 5), DatumPoint(6, 7))
    constraints = [
        hp(Constraint.LinesAtAngle(line0, line1, AngleKind.Other, Angle.from_radians(angle)))
    ]
    guesses = []
    for i, (x, y) in enumerate(points):
        guesses += [(2 * i, float(x)), (2 * i + 1, float(y))]
    outcome = ez.solve(constraints, guesses, Config().with_max_iterations(100))
    assert outcome.is_satisfied()
    assert outcome.iterations == expected_iters, f"angle {angle}"


@pytest.mark.parametrize(
    "angle,expected_iters",
    [(0.1 * PI, 3), (-0.1 * PI, 4)],
)
def test_lines_angle_sign_check(angle, expected_iters):
    """tests.rs:1609-1684."""
    p0 = DatumPoint(0, 1)
    p1 = DatumPoint(2, 3)
    p2 = DatumPoint(4, 5)
    line0 = DatumLineSegment(p0, p1)
    line1 = DatumLineSegment(p1, p2)
    constraints = [
        hp(Constraint.Fixed(0, 0.0)),
        hp(Constraint.Fixed(1, 0.0)),
        hp(Constraint.Fixed(2, 1.0)),
        hp(Constraint.Fixed(3, 0.0)),
        hp(Constraint.LinesAtAngle(line0, line1, AngleKind.Other, Angle.from_radians(angle))),
    ]
    guesses = [(0, 0.0), (1, 0.0), (2, 1.0), (3, 0.0), (4, 2.0), (5, 1.0)]
    outcome = ez.solve(constraints, guesses, Config().with_max_iterations(100))
    assert outcome.is_satisfied()
    assert outcome.iterations == expected_iters

    fv = outcome.final_values
    ux, uy = fv[2] - fv[0], fv[3] - fv[1]
    vx, vy = fv[4] - fv[2], fv[5] - fv[3]
    assert_nearly_eq(math.atan2(ux * vy - uy * vx, ux * vx + uy * vy), angle)


def _points_at_angle_from_vals(vals):
    ux, uy = vals[2] - vals[0], vals[3] - vals[1]
    vx, vy = vals[4] - vals[0], vals[5] - vals[1]
    return math.atan2(ux * vy - uy * vx, ux * vx + uy * vy)


@pytest.mark.parametrize(
    "p1,p2,angle",
    [
        ([1.0, 0.0], [0.0, 2.0], 0.5 * PI),
        ([1.0, 0.0], [0.0, -2.0], -0.5 * PI),
        ([1.0, 0.0], [3.0, 0.0], 0.0),
        ([1.0, 0.0], [-2.0, 0.0], PI),
        ([2.0, 0.0], [1.0, 1.0], 0.25 * PI),
    ],
)
def test_points_at_angle_already_satisfied(p1, p2, angle):
    vertex = DatumPoint(0, 1)
    d1 = DatumPoint(2, 3)
    d2 = DatumPoint(4, 5)
    constraints = [
        hp(Constraint.PointsAtAngle(vertex, d1, d2, AngleKind.Other, Angle.from_radians(angle)))
    ]
    guesses = [(0, 0.0), (1, 0.0), (2, p1[0]), (3, p1[1]), (4, p2[0]), (5, p2[1])]
    outcome = ez.solve(constraints, guesses, Config().with_max_iterations(100))
    assert outcome.is_satisfied()
    assert outcome.iterations == 0


def test_points_at_angle_degenerate():
    vertex = DatumPoint(0, 1)
    p1 = DatumPoint(2, 3)
    p2 = DatumPoint(4, 5)
    constraints = [
        hp(Constraint.PointsAtAngle(vertex, p1, p2, AngleKind.Other, Angle.from_degrees(180.0)))
    ]
    guesses = [(0, 0.0), (1, 0.0), (2, 13.0), (3, 13.0), (4, 13.0), (5, 13.0)]
    outcome = ez.solve(constraints, guesses, Config().with_max_iterations(100))
    assert outcome.warnings and outcome.warnings[0].content is WarningKind.DEGENERATE


def test_points_at_angle_unique_solution():
    vertex = DatumPoint(0, 1)
    p1 = DatumPoint(2, 3)
    p2 = DatumPoint(4, 5)
    target = 0.25 * PI
    constraints = [
        hp(Constraint.Fixed(0, 0.0)),
        hp(Constraint.Fixed(1, 0.0)),
        hp(Constraint.Fixed(2, 1.0)),
        hp(Constraint.Fixed(3, 0.0)),
        hp(Constraint.PointsAtAngle(vertex, p1, p2, AngleKind.Other, Angle.from_radians(target))),
    ]
    for p2_guess in [(1.0, 1.0), (-1.0, -1.0)]:
        guesses = [(0, 0.0), (1, 0.0), (2, 1.0), (3, 0.0), (4, p2_guess[0]), (5, p2_guess[1])]
        outcome = ez.solve(constraints, guesses, Config().with_max_iterations(100))
        assert outcome.is_satisfied()
        assert_nearly_eq(_points_at_angle_from_vals(outcome.final_values), target)


@pytest.mark.parametrize(
    "target,init_p2",
    [
        (0.25 * PI, [1.0, 0.0]),
        (-0.25 * PI, [1.0, 0.0]),
        (0.25 * PI, [0.0, 1.0]),
        (-0.25 * PI, [0.0, 1.0]),
        (0.25 * PI, [-1.0, 0.0]),
        (-0.25 * PI, [-1.0, 0.0]),
        (0.25 * PI, [0.0, -1.0]),
        (-0.25 * PI, [0.0, -1.0]),
    ],
)
def test_points_at_angle_sign_distinguishable(target, init_p2):
    vertex = DatumPoint(0, 1)
    p1 = DatumPoint(2, 3)
    p2 = DatumPoint(4, 5)
    constraints = [
        hp(Constraint.Fixed(0, 0.0)),
        hp(Constraint.Fixed(1, 0.0)),
        hp(Constraint.Fixed(2, 1.0)),
        hp(Constraint.Fixed(3, 0.0)),
        hp(Constraint.Distance(vertex, p2, 1.0)),
        hp(Constraint.PointsAtAngle(vertex, p1, p2, AngleKind.Other, Angle.from_radians(target))),
    ]
    guesses = [(0, 0.0), (1, 0.0), (2, 1.0), (3, 0.0), (4, init_p2[0]), (5, init_p2[1])]
    outcome = ez.solve(constraints, guesses, Config().with_max_iterations(100))
    assert outcome.is_satisfied()
    assert_nearly_eq(_points_at_angle_from_vals(outcome.final_values), target)


def test_textual_warnings():
    """tests.rs:1129-1158."""
    txt = """# constraints
point p
point q
p.x = 0
p.y = 0
q.y = 0
vertical(p, q)
point r
point s
r.x = 0
s.x = 0
s.y = 0
lines_at_angle(p, q, r, s, 0rad)

# guesses
p roughly (3, 4)
q roughly (5, 6)
r roughly (3, 4)
s roughly (5, 6)
"""
    from ezpz_jax.textual import Problem

    solved = Problem.from_str(txt).to_constraint_system().solve()
    assert solved.warnings
    assert any(
        w.about_constraint == 7 and w.content is WarningKind.SHOULD_BE_PARALLEL
        for w in solved.warnings
    )


def test_time_resolves_timing_invariants():
    """time_resolves returns a PER-SOLVE MEAN in seconds: positive and no
    larger than the wall time of the whole call, for both the synchronous
    and the pipelined protocol, on a cascade with two priority tiers (the
    pipelined replay must execute the same inclusive tier subsets — an
    exclusive comparison dispatches an empty tier and blows up).
    Mutation-found: the division/subtraction in both returns, the
    replay's tier-subset comparison, and the documented 100x default."""
    import inspect
    import time as _time

    import ezpz_jax as ez
    from ezpz_jax.api import time_resolves

    ids = ez.IdGenerator()
    p = ez.DatumPoint.new(ids)
    reqs = [
        ez.ConstraintRequest(constraint=ez.Constraint.Fixed(p.id_x(), 1.0),
                             priority=0, weight=1.0),
        ez.ConstraintRequest(constraint=ez.Constraint.Fixed(p.id_y(), 2.0),
                             priority=1, weight=1.0),
    ]
    guesses = [(p.id_x(), 0.5), (p.id_y(), 1.5)]
    ez.solve(reqs, guesses)  # warm the caches outside the timed region

    t0 = _time.perf_counter()
    mean_sync = time_resolves(reqs, guesses, iters=3)
    wall_sync = _time.perf_counter() - t0
    assert 0.0 < mean_sync <= wall_sync

    t0 = _time.perf_counter()
    mean_pipe = time_resolves(reqs, guesses, iters=3, pipelined=True)
    wall_pipe = _time.perf_counter() - t0
    assert 0.0 < mean_pipe <= wall_pipe

    assert inspect.signature(time_resolves).parameters["iters"].default == 100
