"""Per-constraint-type residual kernels.

Each kernel is a pure function ``fn(v, p) -> (res, deg)`` where

* ``v`` is the ``(nv,)`` vector of this constraint instance's variable values
  (gathered from the flat variable vector by the compiled system),
* ``p`` is the ``(np,)`` vector of static parameters,
* ``res`` is the ``(dim,)`` residual vector, and
* ``deg`` is a scalar bool: the configuration is degenerate (the reference
  emits a warning and zeroes the Jacobian row in this case).

Jacobians are taken with ``jax.jacfwd`` of these kernels. The reference
property-tests analytic == finite-difference Jacobians for every constraint
(``ezpz/src/tests/proptests.rs:188-234``), so autodiff of the same residual
reproduces the reference's hand-written Jacobians wherever they are defined.

Degenerate handling: where the reference *zeroes the residual* on degeneracy
(e.g. LineTangentToCircle, ``constraints.rs:531``), we return 0 there; where
the residual stays live but the Jacobian row is emptied (e.g. Distance,
``constraints.rs:1174``), we wrap the raw value in ``stop_gradient`` under
the degenerate branch so the value matches and the derivative is zero. All
denominators are sanitized *before* use so no NaN ever enters the autodiff
graph.

These kernels get vmapped over all instances of a type, which XLA fuses into
a handful of elementwise ops per type — the batched replacement for
the reference's row-at-a-time enum dispatch (``ezpz/src/solver.rs:318-440``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

import jax
import jax.numpy as jnp

EPSILON = 1e-4  # ezpz/src/lib.rs:43
_EPS2 = EPSILON * EPSILON


def _guard(deg, raw, smooth):
    """Residual value = raw (reference value) when degenerate, but with zero
    derivative; the smooth branch is exact elsewhere."""
    return jnp.where(deg, jax.lax.stop_gradient(raw), smooth)


def _safe_sqrt(q, deg):
    """sqrt with a sanitized argument under the degenerate branch (so the
    derivative graph is NaN-free)."""
    return jnp.sqrt(jnp.where(deg, 1.0, q))


def _cross(ax, ay, bx, by):
    return ax * by - ay * bx


# ---------------------------------------------------------------------------
# Kernels. Variable orders are documented per kernel and must match the
# lowering in ezpz_jax.constraints.


def k_line_tangent_circle(v, p):
    """vars [p0x p0y p1x p1y cx cy r]; params [side_sign] (+1 Left, -1 Right).

    Residual: side * cross(p1-p0, c-p0)/|p1-p0| - |r|   (constraints.rs:509-544)
    """
    p0x, p0y, p1x, p1y, cx, cy, r = v
    side = p[0]
    ux, uy = p1x - p0x, p1y - p0y
    q = ux * ux + uy * uy
    deg = q <= _EPS2
    mag = _safe_sqrt(q, deg)
    vx, vy = cx - p0x, cy - p0y
    cen_dist = side * _cross(ux, uy, vx, vy) / mag
    res = _guard(deg, 0.0, cen_dist - jnp.abs(r))
    return jnp.stack([res]), deg


def k_circle_tangent_circle(v, p):
    """vars [ax ay ar bx by br]; params [interior] (1 Interior, 0 Exterior).

    Residual: interior ? ||ra|-|rb|| - d : |ra|+|rb| - d  (constraints.rs:545-564)
    Jacobian degenerate when centers coincide (constraints.rs:1107).
    """
    ax, ay, ar, bx, by, br = v
    interior = p[0]
    dx, dy = ax - bx, ay - by
    q = dx * dx + dy * dy
    deg = q <= _EPS2
    dist_smooth = _safe_sqrt(q, deg)
    dist_raw = jnp.sqrt(q)
    ra, rb = jnp.abs(ar), jnp.abs(br)
    r_int = jnp.abs(ra - rb)
    r_ext = ra + rb
    base = jnp.where(interior > 0.5, r_int, r_ext)
    res = _guard(deg, base - dist_raw, base - dist_smooth)
    return jnp.stack([res]), deg


def k_distance(v, p):
    """vars [p0x p0y p1x p1y]; params [d].

    Residual: |p0-p1| - d (constraints.rs:565-574). Jacobian degenerate when
    the points coincide (constraints.rs:1174); the residual itself stays live.
    """
    x0, y0, x1, y1 = v
    dx, dy = x0 - x1, y0 - y1
    q = dx * dx + dy * dy
    deg = q < _EPS2
    res = _guard(deg, jnp.sqrt(q) - p[0], _safe_sqrt(q, deg) - p[0])
    return jnp.stack([res]), deg


def k_distance_var(v, p):
    """vars [px py qx qy d]; no params.

    Residual: |p-q| - d where d is a solver variable (constraints.rs:575-583).
    """
    px, py, qx, qy, d = v
    dx, dy = px - qx, py - qy
    q = dx * dx + dy * dy
    deg = q < _EPS2
    res = _guard(deg, jnp.sqrt(q) - d, _safe_sqrt(q, deg) - d)
    return jnp.stack([res]), deg


def k_vertical_distance(v, p):
    """vars [p0y p1y]; params [d]. Residual: y0 - y1 - d (constraints.rs:584-591)."""
    return jnp.stack([v[0] - v[1] - p[0]]), jnp.asarray(False)


def k_horizontal_distance(v, p):
    """vars [p0x p1x]; params [d]. Residual: x0 - x1 - d (constraints.rs:592-596)."""
    return jnp.stack([v[0] - v[1] - p[0]]), jnp.asarray(False)


def k_vertical(v, p):
    """vars [p0x p1x]. Residual: x0 - x1 (constraints.rs:597-601)."""
    return jnp.stack([v[0] - v[1]]), jnp.asarray(False)


def k_horizontal(v, p):
    """vars [p0y p1y]. Residual: y0 - y1 (constraints.rs:602-606)."""
    return jnp.stack([v[0] - v[1]]), jnp.asarray(False)


def k_fixed(v, p):
    """vars [x]; params [expected]. Residual: x - expected (constraints.rs:607-610)."""
    return jnp.stack([v[0] - p[0]]), jnp.asarray(False)


def k_scalar_equal(v, p):
    """vars [x y]. Residual: x - y (constraints.rs:611-616)."""
    return jnp.stack([v[0] - v[1]]), jnp.asarray(False)


def k_lines_at_angle(v, p):
    """vars [x0 y0 x1 y1 x2 y2 x3 y3]; params [sin cos] of the target angle.

    Residual: cross(u, R^-1 v) / ((|u|+|v|)/2), scale-normalized
    (constraints.rs:617-640). Degenerate if either line has ~zero length.
    """
    x0, y0, x1, y1, x2, y2, x3, y3 = v
    s, c = p[0], p[1]
    ux, uy = x1 - x0, y1 - y0
    vx, vy = x3 - x2, y3 - y2
    qu = ux * ux + uy * uy
    qv = vx * vx + vy * vy
    deg = (qu <= _EPS2) | (qv <= _EPS2)
    lu = _safe_sqrt(qu, deg)
    lv = _safe_sqrt(qv, deg)
    # R^-1 v with R = [[c, -s], [s, c]] -> R^-1 = [[c, s], [-s, c]]
    rvx = c * vx + s * vy
    rvy = -s * vx + c * vy
    res = _cross(ux, uy, rvx, rvy) / ((lu + lv) * 0.5)
    res = _guard(deg, 0.0, res)
    return jnp.stack([res]), deg


def k_points_coincident(v, p):
    """vars [p0x p0y p1x p1y]. Residuals: [x0-x1, y0-y1] (constraints.rs:641-648)."""
    return jnp.stack([v[0] - v[2], v[1] - v[3]]), jnp.asarray(False)


def k_circle_radius(v, p):
    """vars [r]; params [expected]. Residual: r - expected (constraints.rs:649-652)."""
    return jnp.stack([v[0] - p[0]]), jnp.asarray(False)


def k_lines_equal_length(v, p):
    """vars [x0 y0 x1 y1 x2 y2 x3 y3].

    Residual: |l0| - |l1| (constraints.rs:653-658). Jacobian degenerate when
    either line has ~zero length (constraints.rs:1437); the residual stays live.
    """
    x0, y0, x1, y1, x2, y2, x3, y3 = v
    q0 = (x0 - x1) ** 2 + (y0 - y1) ** 2
    q1 = (x2 - x3) ** 2 + (y2 - y3) ** 2
    deg = (q0 < _EPS2) | (q1 < _EPS2)
    raw = jnp.sqrt(q0) - jnp.sqrt(q1)
    smooth = _safe_sqrt(q0, deg) - _safe_sqrt(q1, deg)
    res = _guard(deg, raw, smooth)
    return jnp.stack([res]), deg


def k_arc(v, p):
    """vars [sx sy ex ey cx cy].

    Residual: |s-c| - |e-c| (constraints.rs:683-696). Jacobian degenerate
    when either radius is ~zero (constraints.rs:1559).
    """
    sx, sy, ex, ey, cx, cy = v
    q0 = (sx - cx) ** 2 + (sy - cy) ** 2
    q1 = (ex - cx) ** 2 + (ey - cy) ** 2
    deg = (q0 <= _EPS2) | (q1 <= _EPS2)
    raw = jnp.sqrt(q0) - jnp.sqrt(q1)
    smooth = _safe_sqrt(q0, deg) - _safe_sqrt(q1, deg)
    res = _guard(deg, raw, smooth)
    return jnp.stack([res]), deg


def k_midpoint(v, p):
    """vars [px py qx qy ax ay] (line p-q, midpoint a).

    Residuals: [ax - px/2 - qx/2, ay - py/2 - qy/2] (constraints.rs:697-711).
    """
    px, py, qx, qy, ax, ay = v
    return jnp.stack([ax - px / 2.0 - qx / 2.0, ay - py / 2.0 - qy / 2.0]), jnp.asarray(False)


def k_point_line_distance(v, p):
    """vars [px py p0x p0y p1x p1y]; params [d].

    Signed point-line distance: (A px + B py + C)/hypot(A, B) - d with the
    line as Ax + By + C = 0 (constraints.rs:712-740). Degenerate (residual
    zeroed) when the line is ~zero length.
    """
    px, py, p0x, p0y, p1x, p1y = v
    a = p0y - p1y
    b = p1x - p0x
    c = p0x * p1y - p1x * p0y
    q = a * a + b * b
    deg = q < _EPS2
    denom = _safe_sqrt(q, deg)
    res = (a * px + b * py + c) / denom - p[0]
    res = _guard(deg, 0.0, res)
    return jnp.stack([res]), deg


def k_vertical_point_line_distance(v, p):
    """vars [ax ay px py qx qy]; params [d].

    Residual: ay - py - (qy-py)/(qx-px) * (ax-px) - d (constraints.rs:741-762).
    Degenerate for a vertical or zero-length line.
    """
    ax, ay, px, py, qx, qy = v
    dx, dy = qx - px, qy - py
    deg = (jnp.abs(dx) <= EPSILON) | ((dx * dx + dy * dy) <= _EPS2)
    dx_s = jnp.where(deg, 1.0, dx)
    res = ay - py - dy / dx_s * (ax - px) - p[0]
    res = _guard(deg, 0.0, res)
    return jnp.stack([res]), deg


def k_horizontal_point_line_distance(v, p):
    """vars [ax ay px py qx qy]; params [d].

    Residual: ax - px - (qx-px)/(qy-py) * (ay-py) - d (constraints.rs:763-785).
    Degenerate for a horizontal or zero-length line.
    """
    ax, ay, px, py, qx, qy = v
    dx, dy = qx - px, qy - py
    deg = (jnp.abs(dy) <= EPSILON) | ((dx * dx + dy * dy) <= _EPS2)
    dy_s = jnp.where(deg, 1.0, dy)
    res = ax - px - dx / dy_s * (ay - py) - p[0]
    res = _guard(deg, 0.0, res)
    return jnp.stack([res]), deg


def k_symmetric(v, p):
    """vars [px py qx qy ax ay bx by] (mirror line p-q; points a, b).

    Residual: reflect(a-p, q-p) - b + p, two rows (constraints.rs:786-808).
    The Jacobian is degenerate when |q-p|^4 < EPSILON (constraints.rs:2378-2383,
    note the reference compares the *squared* squared length to EPSILON).
    """
    px, py, qx, qy, ax, ay, bx, by = v
    dx, dy = qx - px, qy - py
    r = dx * dx + dy * dy
    deg = (r * r) < EPSILON
    r_s = jnp.where(deg, 1.0, r)
    sx, sy = ax - px, ay - py
    # reflect(s, d) = 2 * proj(s, d) - s = 2 d (s.d)/(d.d) - s
    dot = sx * dx + sy * dy
    refx = 2.0 * dx * dot / r_s - sx
    refy = 2.0 * dy * dot / r_s - sy
    # Raw (degenerate-branch) value: the reference divides by the
    # unsanitized |q-p|^2 and emits NaN when the mirror endpoints coincide
    # exactly (vector.rs reflect -> reject, 0/0). A NaN residual poisons
    # the whole solve, so we deliberately deviate: divide by a zero-guarded
    # denominator, keeping the value finite while the degenerate flag (and
    # its warning) still fires.
    r_z = jnp.where(r == 0.0, 1.0, r)
    raw_refx = 2.0 * dx * dot / r_z - sx
    raw_refy = 2.0 * dy * dot / r_z - sy
    r0 = _guard(deg, raw_refx - bx + px, refx - bx + px)
    r1 = _guard(deg, raw_refy - by + py, refy - by + py)
    return jnp.stack([r0, r1]), deg


_TWO_PI = 6.283185307179586476925286766559


def k_point_arc_coincident(v, p):
    """vars [cx cy sx sy ex ey px py].

    Piecewise residual (constraints.rs:809-858): classify the point against
    the CCW arc span (constraints.rs:2593-2606); interior pulls radially to
    the circle, outside pulls to the nearest endpoint.
    """
    cx, cy, sx, sy, ex, ey, px, py = v
    sxr, syr = sx - cx, sy - cy
    exr, eyr = ex - cx, ey - cy
    pxr, pyr = px - cx, py - cy
    qs = sxr * sxr + syr * syr
    qe = exr * exr + eyr * eyr
    qp = pxr * pxr + pyr * pyr
    deg = (qs < _EPS2) | (qe < _EPS2) | (qp < _EPS2)
    r = _safe_sqrt(qs, deg)
    r_e = _safe_sqrt(qe, deg)
    r_p = _safe_sqrt(qp, deg)

    # e projected onto the circle of radius r.
    scale_e = r / r_e
    epx, epy = exr * scale_e, eyr * scale_e

    # CCW angles from s (classification is piecewise-constant; its value at
    # the evaluation point selects the branch, matching the reference).
    a_sp = jnp.mod(jnp.arctan2(_cross(sxr, syr, pxr, pyr), sxr * pxr + syr * pyr), _TWO_PI)
    a_se = jnp.mod(jnp.arctan2(_cross(sxr, syr, epx, epy), sxr * epx + syr * epy), _TWO_PI)
    interior = a_sp < a_se
    d_end2 = (epx - pxr) ** 2 + (epy - pyr) ** 2
    d_start2 = (sxr - pxr) ** 2 + (syr - pyr) ** 2
    nearest_end = d_end2 < d_start2

    f_int = (pxr * (r / r_p - 1.0), pyr * (r / r_p - 1.0))
    f_end = (epx - pxr, epy - pyr)
    f_start = (sxr - pxr, syr - pyr)

    r0 = jnp.where(interior, f_int[0], jnp.where(nearest_end, f_end[0], f_start[0]))
    r1 = jnp.where(interior, f_int[1], jnp.where(nearest_end, f_end[1], f_start[1]))
    r0 = _guard(deg, 0.0, r0)
    r1 = _guard(deg, 0.0, r1)
    return jnp.stack([r0, r1]), deg


def k_arc_length(v, p):
    """vars [cx cy ax ay bx by]; params [d].

    Residual: (b - c) - R(d/|a-c|) (a - c), two rows in length units
    (constraints.rs:859-896).
    """
    cx, cy, ax, ay, bx, by = v
    d = p[0]
    ux, uy = ax - cx, ay - cy
    r2 = ux * ux + uy * uy
    deg = r2 <= _EPS2
    r = _safe_sqrt(r2, deg)
    alpha = d / r
    sa, ca = jnp.sin(alpha), jnp.cos(alpha)
    rux = ca * ux - sa * uy
    ruy = sa * ux + ca * uy
    r0 = _guard(deg, 0.0, (bx - cx) - rux)
    r1 = _guard(deg, 0.0, (by - cy) - ruy)
    return jnp.stack([r0, r1]), deg


def k_points_at_angle(v, p):
    """vars [p0x p0y p1x p1y p2x p2y]; params [sin cos].

    Residual: (|u| v - |v| R u) / ((|u|+|v|)/2), two rows, u = p1-p0,
    v = p2-p0 (constraints.rs:916-948). Unlike LinesAtAngle this is
    sign-sensitive with a unique solution.
    """
    x0, y0, x1, y1, x2, y2 = v
    s, c = p[0], p[1]
    ux, uy = x1 - x0, y1 - y0
    vx, vy = x2 - x0, y2 - y0
    qu = ux * ux + uy * uy
    qv = vx * vx + vy * vy
    deg = (qu <= _EPS2) | (qv <= _EPS2)
    lu = _safe_sqrt(qu, deg)
    lv = _safe_sqrt(qv, deg)
    # R u with R = [[c, -s], [s, c]]
    rux = c * ux - s * uy
    ruy = s * ux + c * uy
    inv_scale = 1.0 / ((lu + lv) * 0.5)
    r0 = _guard(deg, 0.0, (vx * lu - rux * lv) * inv_scale)
    r1 = _guard(deg, 0.0, (vy * lu - ruy * lv) * inv_scale)
    return jnp.stack([r0, r1]), deg


# ---------------------------------------------------------------------------
# Registry


@dataclass(frozen=True)
class KernelSpec:
    name: str
    nvars: int
    nparams: int
    dim: int
    fn: Callable
    # False for kernels whose degenerate flag is constant False (pure
    # linear/affine residuals): their flag scatters are skipped entirely in
    # the hot evaluation loops.
    can_degenerate: bool = True


KERNELS: Dict[str, KernelSpec] = {
    spec.name: spec
    for spec in [
        KernelSpec("line_tangent_circle", 7, 1, 1, k_line_tangent_circle),
        KernelSpec("circle_tangent_circle", 6, 1, 1, k_circle_tangent_circle),
        KernelSpec("distance", 4, 1, 1, k_distance),
        KernelSpec("distance_var", 5, 0, 1, k_distance_var),
        KernelSpec("vertical_distance", 2, 1, 1, k_vertical_distance, can_degenerate=False),
        KernelSpec("horizontal_distance", 2, 1, 1, k_horizontal_distance, can_degenerate=False),
        KernelSpec("vertical", 2, 0, 1, k_vertical, can_degenerate=False),
        KernelSpec("horizontal", 2, 0, 1, k_horizontal, can_degenerate=False),
        KernelSpec("lines_at_angle", 8, 2, 1, k_lines_at_angle),
        KernelSpec("fixed", 1, 1, 1, k_fixed, can_degenerate=False),
        KernelSpec("scalar_equal", 2, 0, 1, k_scalar_equal, can_degenerate=False),
        KernelSpec("points_coincident", 4, 0, 2, k_points_coincident, can_degenerate=False),
        KernelSpec("circle_radius", 1, 1, 1, k_circle_radius, can_degenerate=False),
        KernelSpec("lines_equal_length", 8, 0, 1, k_lines_equal_length),
        KernelSpec("arc", 6, 0, 1, k_arc),
        KernelSpec("midpoint", 6, 0, 2, k_midpoint, can_degenerate=False),
        KernelSpec("point_line_distance", 6, 1, 1, k_point_line_distance),
        KernelSpec("vertical_point_line_distance", 6, 1, 1, k_vertical_point_line_distance),
        KernelSpec("horizontal_point_line_distance", 6, 1, 1, k_horizontal_point_line_distance),
        KernelSpec("symmetric", 8, 0, 2, k_symmetric),
        KernelSpec("point_arc_coincident", 8, 0, 2, k_point_arc_coincident),
        KernelSpec("arc_length", 6, 1, 2, k_arc_length),
        KernelSpec("points_at_angle", 6, 2, 2, k_points_at_angle),
    ]
}
