"""Randomized end-to-end solves per constraint family, mirroring the
reference's family proptests (``ezpz/src/tests/proptests.rs``): scalar_eq
(:332), vertical/horizontal distance (:362,:401), point-line distances
(:442,:472), point-arc coincident (:515), arc length (:545), circle
tangency (:571), DistanceVar finiteness/symmetry (:601-711).

Each family solves a handful of randomized instances; topology is fixed per
family so the jitted solver compiles once and random values re-use it.
"""

import math

import numpy as np

import ezpz_jax as ez
from ezpz_jax.constraints import Constraint, ConstraintRequest
from ezpz_jax.datatypes import (
    DatumCircle,
    DatumCircularArc,
    DatumDistance,
    DatumLineSegment,
    DatumPoint,
)

RNG = np.random.default_rng(987)
N_CASES = 5


def _solve(constraints, guesses):
    reqs = [ConstraintRequest.highest_priority(c) for c in constraints]
    return ez.solve(reqs, guesses, ez.Config())


def test_scalar_equal_family():
    x, y = 0, 1
    for _ in range(N_CASES):
        a = float(RNG.uniform(-50, 50))
        out = _solve(
            [Constraint.Fixed(x, a), Constraint.ScalarEqual(x, y)],
            [(x, a + RNG.uniform(-1, 1)), (y, RNG.uniform(-60, 60))],
        )
        assert out.converged
        assert abs(out.final_values[y] - a) < 1e-6


def test_vertical_horizontal_distance_family():
    p, q = DatumPoint(0, 1), DatumPoint(2, 3)
    for _ in range(N_CASES):
        px, py = RNG.uniform(-20, 20, 2)
        d, e = RNG.uniform(-10, 10, 2)
        out = _solve(
            [
                Constraint.Fixed(p.x_id, px),
                Constraint.Fixed(p.y_id, py),
                Constraint.VerticalDistance(p, q, float(d)),    # p.y - q.y = d
                Constraint.HorizontalDistance(p, q, float(e)),  # p.x - q.x = e
            ],
            [(0, px), (1, py), (2, px + RNG.uniform(-1, 1)), (3, py + RNG.uniform(-1, 1))],
        )
        assert out.converged
        assert abs((py - out.final_values[3]) - d) < 1e-6
        assert abs((px - out.final_values[2]) - e) < 1e-6


def test_point_line_distance_family():
    a, b, p = DatumPoint(0, 1), DatumPoint(2, 3), DatumPoint(4, 5)
    line = DatumLineSegment(a, b)
    for _ in range(N_CASES):
        ax, ay = RNG.uniform(-5, 5, 2)
        bx, by = ax + RNG.uniform(1, 5), ay + RNG.uniform(1, 5)
        d = float(RNG.uniform(0.5, 4.0))
        # Start p clearly on the positive side of the signed distance.
        mx, my = (ax + bx) / 2, (ay + by) / 2
        nx, ny = -(by - ay), (bx - ax)
        nn = math.hypot(nx, ny)
        px0, py0 = mx + 2 * d * nx / nn, my + 2 * d * ny / nn
        out = _solve(
            [
                Constraint.Fixed(a.x_id, ax), Constraint.Fixed(a.y_id, ay),
                Constraint.Fixed(b.x_id, bx), Constraint.Fixed(b.y_id, by),
                Constraint.PointLineDistance(p, line, d),
            ],
            [(0, ax), (1, ay), (2, bx), (3, by), (4, px0), (5, py0)],
        )
        assert out.converged, (ax, ay, bx, by, d)
        px, py = out.final_values[4], out.final_values[5]
        dist = abs((by - ay) * px - (bx - ax) * py + bx * ay - by * ax) / math.hypot(
            bx - ax, by - ay
        )
        assert abs(dist - d) < 1e-5
        # Sign preserved: p stayed on the side it started.
        side = (bx - ax) * (py - ay) - (by - ay) * (px - ax)
        side0 = (bx - ax) * (py0 - ay) - (by - ay) * (px0 - ax)
        assert side * side0 > 0


def test_axis_point_line_distance_slanted_family():
    """Vertical/HorizontalPointLineDistance against SLANTED lines: the
    slope term dy/dx*(ax-px) (resp. dx/dy*(ay-py)) must actually bite
    (a tools/mutate.py run showed sign mutations of that term surviving —
    the previous coverage used geometries where it vanished).
    Solved values checked against the closed-form residual."""
    a, b, p = DatumPoint(0, 1), DatumPoint(2, 3), DatumPoint(4, 5)
    line = DatumLineSegment(a, b)
    for _ in range(N_CASES):
        ax, ay = RNG.uniform(-5, 5, 2)
        bx, by = ax + RNG.uniform(1, 4), ay + RNG.uniform(1, 4)  # slanted
        d = float(RNG.uniform(0.5, 3.0))
        px = ax + RNG.uniform(0.5, 2.0)
        # Vertical distance: ay' at solved p satisfies
        # py - line_y_at(px) = d, with px held fixed.
        out = _solve(
            [
                Constraint.Fixed(a.x_id, ax), Constraint.Fixed(a.y_id, ay),
                Constraint.Fixed(b.x_id, bx), Constraint.Fixed(b.y_id, by),
                Constraint.Fixed(p.x_id, px),
                Constraint.VerticalPointLineDistance(p, line, d),
            ],
            [(0, ax), (1, ay), (2, bx), (3, by), (4, px),
             (5, ay + d + 1.0)],
        )
        assert out.converged
        py = out.final_values[5]
        line_y = ay + (by - ay) / (bx - ax) * (px - ax)
        assert abs((py - line_y) - d) < 1e-5

        # Horizontal distance: px' - line_x_at(py) = d, with py held fixed.
        py2 = ay + RNG.uniform(0.5, 2.0)
        out = _solve(
            [
                Constraint.Fixed(a.x_id, ax), Constraint.Fixed(a.y_id, ay),
                Constraint.Fixed(b.x_id, bx), Constraint.Fixed(b.y_id, by),
                Constraint.Fixed(p.y_id, py2),
                Constraint.HorizontalPointLineDistance(p, line, d),
            ],
            [(0, ax), (1, ay), (2, bx), (3, by), (4, ax + d + 1.0),
             (5, py2)],
        )
        assert out.converged
        px2 = out.final_values[4]
        line_x = ax + (bx - ax) / (by - ay) * (py2 - ay)
        assert abs((px2 - line_x) - d) < 1e-5


def test_symmetric_off_origin_family():
    """Symmetric with the mirror line NOWHERE near the origin: the
    reflection formula's q-p direction terms must bite individually
    (mutation testing showed sign flips surviving on origin-anchored
    data). Check the solved b is the exact geometric reflection of a."""
    line = DatumLineSegment(DatumPoint(0, 1), DatumPoint(2, 3))
    a, b = DatumPoint(4, 5), DatumPoint(6, 7)
    for _ in range(N_CASES):
        px, py = RNG.uniform(3, 8, 2)  # far from origin
        qx, qy = px + RNG.uniform(1, 3), py + RNG.uniform(-3, -1)
        ax, ay = px + RNG.uniform(-2, 2), py + RNG.uniform(0.5, 2.5)
        out = _solve(
            [
                Constraint.Fixed(0, px), Constraint.Fixed(1, py),
                Constraint.Fixed(2, qx), Constraint.Fixed(3, qy),
                Constraint.Fixed(4, ax), Constraint.Fixed(5, ay),
                Constraint.Symmetric(line, a, b),
            ],
            [(0, px), (1, py), (2, qx), (3, qy), (4, ax), (5, ay),
             (6, ax + 0.5), (7, ay - 0.5)],
        )
        assert out.converged
        bx, by = out.final_values[6], out.final_values[7]
        # Exact reflection: b = 2*proj_line(a) - a.
        dx, dy = qx - px, qy - py
        t = ((ax - px) * dx + (ay - py) * dy) / (dx * dx + dy * dy)
        fx, fy = px + t * dx, py + t * dy  # foot of perpendicular
        assert abs(bx - (2 * fx - ax)) < 1e-5
        assert abs(by - (2 * fy - ay)) < 1e-5


def test_point_arc_coincident_family():
    arc = DatumCircularArc(
        center=DatumPoint(0, 1), start=DatumPoint(2, 3), end=DatumPoint(4, 5)
    )
    p = DatumPoint(6, 7)
    for _ in range(N_CASES):
        r = float(RNG.uniform(1.0, 4.0))
        # Arc spans the first quadrant; p starts strictly interior to it.
        theta = float(RNG.uniform(0.3, 1.2))
        guesses = [
            (0, 0.0), (1, 0.0),
            (2, r), (3, 0.0),
            (4, 0.0), (5, r),
            (6, 0.7 * r * math.cos(theta)), (7, 0.7 * r * math.sin(theta)),
        ]
        out = _solve(
            [
                Constraint.Fixed(0, 0.0), Constraint.Fixed(1, 0.0),
                Constraint.Fixed(2, r), Constraint.Fixed(3, 0.0),
                Constraint.Fixed(4, 0.0), Constraint.Fixed(5, r),
                Constraint.PointArcCoincident(arc, p),
            ],
            guesses,
        )
        assert out.converged
        px, py = out.final_values[6], out.final_values[7]
        assert abs(math.hypot(px, py) - r) < 1e-5  # pulled radially onto the arc
        assert px > -1e-6 and py > -1e-6  # stayed in the span


def test_arc_length_family():
    arc = DatumCircularArc(
        center=DatumPoint(0, 1), start=DatumPoint(2, 3), end=DatumPoint(4, 5)
    )
    for _ in range(N_CASES):
        r = float(RNG.uniform(1.0, 3.0))
        frac = float(RNG.uniform(0.2, 0.8))
        target = frac * math.pi * r  # up to ~80% of a half-circle
        theta0 = frac * math.pi
        guesses = [
            (0, 0.0), (1, 0.0),
            (2, r), (3, 0.0),
            (4, r * math.cos(theta0 * 1.1)), (5, r * math.sin(theta0 * 1.1)),
        ]
        out = _solve(
            [
                Constraint.Fixed(0, 0.0), Constraint.Fixed(1, 0.0),
                Constraint.Fixed(2, r), Constraint.Fixed(3, 0.0),
                Constraint.ArcLength(arc, target),
            ],
            guesses,
        )
        assert out.converged
        ex, ey = out.final_values[4], out.final_values[5]
        assert abs(math.hypot(ex, ey) - r) < 1e-5  # end on the circle
        ang = math.atan2(ey, ex) % (2 * math.pi)
        assert abs(ang * r - target) < 1e-4  # arc length matches


def test_circle_tangency_family():
    c0 = DatumCircle(center=DatumPoint(0, 1), radius=DatumDistance(2))
    c1 = DatumCircle(center=DatumPoint(3, 4), radius=DatumDistance(5))
    for _ in range(N_CASES):
        r0 = float(RNG.uniform(0.5, 2.0))
        r1 = float(RNG.uniform(0.5, 2.0))
        gap = float(RNG.uniform(0.1, 2.0))
        out = _solve(
            [
                Constraint.Fixed(0, 0.0), Constraint.Fixed(1, 0.0),
                Constraint.CircleRadius(c0, r0),
                Constraint.CircleRadius(c1, r1),
                Constraint.Fixed(4, 0.0),  # c1 on the x-axis, x free
                Constraint.CircleTangentToCircle(c0, c1),
            ],
            [(0, 0.0), (1, 0.0), (2, r0),
             (3, r0 + r1 + gap), (4, 0.0), (5, r1)],
        )
        assert out.converged
        d = abs(out.final_values[3])
        assert abs(d - (r0 + r1)) < 1e-5  # exterior tangency inferred


def test_circle_tangency_interior_family():
    """INTERIOR tangency: one circle inside the other, center distance
    equals ||r0|-|r1|| (constraints.rs:545-564 interior arm — found
    untested by a tools/mutate.py run: mutating |ra-rb| to |ra+rb|
    survived the suite)."""
    from ezpz_jax.constraints import CircleSide

    c0 = DatumCircle(center=DatumPoint(0, 1), radius=DatumDistance(2))
    c1 = DatumCircle(center=DatumPoint(3, 4), radius=DatumDistance(5))
    for _ in range(N_CASES):
        r0 = float(RNG.uniform(2.0, 4.0))
        r1 = float(RNG.uniform(0.5, 1.0))  # strictly smaller: c1 inside c0
        out = _solve(
            [
                Constraint.Fixed(0, 0.0), Constraint.Fixed(1, 0.0),
                Constraint.CircleRadius(c0, r0),
                Constraint.CircleRadius(c1, r1),
                Constraint.Fixed(4, 0.0),  # c1 on the x-axis, x free
                Constraint.CircleTangentToCircle(c0, c1, CircleSide.Interior),
            ],
            [(0, 0.0), (1, 0.0), (2, r0),
             (3, (r0 - r1) * 0.9), (4, 0.0), (5, r1)],
        )
        assert out.converged
        d = abs(out.final_values[3])
        assert abs(d - (r0 - r1)) < 1e-5  # internally tangent


def test_distance_var_finiteness_and_symmetry():
    p, q = DatumPoint(0, 1), DatumPoint(2, 3)
    dvar = DatumDistance(4)
    for _ in range(N_CASES):
        px, py, qx, qy = RNG.uniform(-10, 10, 4)
        true_d = math.hypot(px - qx, py - qy)
        if true_d < 0.1:
            continue
        for d0 in (true_d * 0.3 + 0.05, true_d * 2.5):  # under/over guesses
            out = _solve(
                [
                    Constraint.Fixed(0, px), Constraint.Fixed(1, py),
                    Constraint.Fixed(2, qx), Constraint.Fixed(3, qy),
                    Constraint.DistanceVar(p, q, dvar),
                ],
                [(0, px), (1, py), (2, qx), (3, qy), (4, d0)],
            )
            assert out.converged
            d = out.final_values[4]
            assert np.isfinite(d)
            assert abs(d - true_d) < 1e-5


def test_line_tangent_circle_slanted_values():
    """Direct value pin for k_line_tangent_circle on a SLANTED line: every
    corpus tangency fixture is axis-aligned (uy == 0), where the
    |p1-p0|^2 = ux^2 + uy^2 sum degenerates to one term and a sign flip
    between the terms is invisible (mutation-found). 3-4-5 geometry gives
    exact analytic residuals."""
    import jax.numpy as jnp
    from ezpz_jax.ops.kernels import k_line_tangent_circle

    # Line (0,0)-(3,4): |u| = 5. Center (0,5): cross(u, c-p0) = 15,
    # signed distance 3. side=+1, r=2 -> residual 1; r=3 -> tangent (0).
    v = jnp.asarray([0.0, 0.0, 3.0, 4.0, 0.0, 5.0, 2.0])
    res, deg = k_line_tangent_circle(v, jnp.asarray([1.0]))
    assert not bool(deg)
    np.testing.assert_allclose(float(res[0]), 1.0, atol=1e-12)
    v_t = jnp.asarray([0.0, 0.0, 3.0, 4.0, 0.0, 5.0, 3.0])
    res_t, _ = k_line_tangent_circle(v_t, jnp.asarray([1.0]))
    np.testing.assert_allclose(float(res_t[0]), 0.0, atol=1e-12)
    # Right side flips the signed distance: residual -3 - 2 = -5.
    res_r, _ = k_line_tangent_circle(v, jnp.asarray([-1.0]))
    np.testing.assert_allclose(float(res_r[0]), -5.0, atol=1e-12)


def test_symmetric_degenerate_branch_values():
    """k_symmetric's degenerate branch emits the RAW reflect value with a
    zero-guarded denominator (deliberate deviation from the reference's
    NaN; kernels.py:298-306). Pin those raw values analytically — the
    only other cover is the DS parity test, outside this file's mutation
    selection."""
    import jax.numpy as jnp
    from ezpz_jax.ops.kernels import k_symmetric

    # Mirror endpoints nearly coincide: r = |q-p|^2 = 2.5e-3, r^2 < 1e-4
    # -> degenerate, but r != 0 so the raw value divides by the TRUE r.
    v = jnp.asarray([0.0, 0.0, 0.05, 0.0, 1.0, 2.0, 3.0, 4.0])
    res, deg = k_symmetric(v, jnp.zeros((0,)))
    assert bool(deg)
    # reflect((1,2), d=(0.05,0)) = (2*0.05*0.05/0.0025 - 1, -2) = (1, -2)
    np.testing.assert_allclose(float(res[0]), 1.0 - 3.0 + 0.0, atol=1e-12)
    np.testing.assert_allclose(float(res[1]), -2.0 - 4.0 + 0.0, atol=1e-12)
    # Exactly coincident endpoints: guarded denominator 1.0, still finite.
    v0 = jnp.asarray([0.0, 0.0, 0.0, 0.0, 1.0, 2.0, 3.0, 4.0])
    res0, deg0 = k_symmetric(v0, jnp.zeros((0,)))
    assert bool(deg0) and np.isfinite(np.asarray(res0)).all()
    np.testing.assert_allclose(float(res0[0]), -1.0 - 3.0, atol=1e-12)
    np.testing.assert_allclose(float(res0[1]), -2.0 - 4.0, atol=1e-12)


def test_circle_tangent_circle_degeneracy_boundary_is_inclusive():
    """Center separation with |a-b|^2 exactly == EPSILON-guard 1e-8: the
    degenerate flag uses ``q <= _EPS2`` (inclusive). dx = sqrt(1e-8) is an
    exact f64 tie (dx*dx == 1e-8 bitwise), pinning the comparison's
    closedness (mutation-found boundary)."""
    import jax.numpy as jnp

    from ezpz_jax.ops.kernels import k_circle_tangent_circle

    dx = float(np.sqrt(np.float64(1e-8)))
    assert dx * dx == 1e-8
    v = [jnp.asarray(x) for x in (0.0, 0.0, 1.0, dx, 0.0, 2.0)]
    rows, deg = k_circle_tangent_circle(v, [jnp.asarray(0.0)])
    assert bool(deg)
    assert np.isfinite(np.asarray(rows)).all()


def test_symmetric_degeneracy_boundary_is_exclusive():
    """k_symmetric flags degeneracy on ``(r*r) < EPSILON`` (strict, the
    reference's comparison of the squared squared mirror length,
    constraints.rs:2378-2383). Engineered exact tie: dx, dy chosen so
    fl(dx^2 + dy^2) == 0.01 and fl(0.01^2) == EPSILON bitwise -- the flag
    must stay False at the tie (mutation-found boundary)."""
    import jax.numpy as jnp

    from ezpz_jax.ops.kernels import EPSILON, k_symmetric

    dx, dy = 0.07806247497997998, 0.0625
    r = np.float64(dx) * dx + np.float64(dy) * dy
    assert r == 0.01 and r * r == EPSILON
    v = [jnp.asarray(x) for x in (0.0, 0.0, dx, dy, 0.3, 0.4, -0.3, 0.4)]
    rows, deg = k_symmetric(v, [])
    assert not bool(deg)
    assert np.isfinite(np.asarray(rows)).all()
