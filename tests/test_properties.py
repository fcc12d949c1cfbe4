"""Property tests mirroring ezpz/src/tests/proptests.rs:

1. autodiff Jacobian == central finite difference of the residual for every
   constraint kind at random non-degenerate points (proptests.rs:188-234);
2. Jacobians are scale-invariant: residuals are homogeneous degree 1 in
   length (proptests.rs:244-292);
3. kernel gather structure == declared dependent variable sets
   (proptests.rs:164-180);
4. randomized end-to-end solves per constraint family.
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import ezpz_jax as ez
from ezpz_jax.constraints import Constraint, ConstraintRequest
from ezpz_jax.datatypes import (
    Angle,
    AngleKind,
    DatumCircle,
    DatumCircularArc,
    DatumDistance,
    DatumLineSegment,
    DatumPoint,
)
from ezpz_jax.ops.kernels import KERNELS

RNG = np.random.default_rng(12345)


def _random_vars(spec, rng):
    """Random variable values, kept away from degenerate configurations."""
    for _ in range(100):
        v = rng.uniform(-10.0, 10.0, size=spec.nvars)
        fn = jax.jit(spec.fn)
        res, deg = fn(jnp.asarray(v), jnp.asarray(_default_params(spec)))
        if not bool(deg) and np.all(np.isfinite(np.asarray(res))):
            return v
    raise AssertionError(f"could not sample non-degenerate vars for {spec.name}")


def _default_params(spec):
    if spec.name in ("lines_at_angle", "points_at_angle"):
        theta = 0.3
        return np.array([math.sin(theta), math.cos(theta)])
    if spec.name == "line_tangent_circle":
        return np.array([1.0])
    if spec.name == "circle_tangent_circle":
        return np.array([0.0])
    return np.full(spec.nparams, 1.7)


@pytest.mark.parametrize("name", sorted(KERNELS.keys()))
def test_autodiff_matches_finite_difference(name):
    spec = KERNELS[name]
    p = jnp.asarray(_default_params(spec))
    fn = lambda v: spec.fn(v, p)[0]
    jac_fn = jax.jit(jax.jacfwd(fn))
    for _ in range(10):
        v = _random_vars(spec, RNG)
        jac = np.asarray(jac_fn(jnp.asarray(v)))
        # Central finite difference.
        h = 1e-6
        fd = np.zeros_like(jac)
        for k in range(spec.nvars):
            vp, vm = v.copy(), v.copy()
            vp[k] += h
            vm[k] -= h
            fd[:, k] = (np.asarray(fn(jnp.asarray(vp))) - np.asarray(fn(jnp.asarray(vm)))) / (
                2 * h
            )
        scale = max(1.0, np.abs(jac).max())
        assert np.allclose(jac, fd, atol=1e-4 * scale), (
            f"{name}: autodiff vs FD mismatch\n{jac}\n{fd}"
        )


_SCALE_INVARIANT_JAC = [
    # Kinds whose Jacobian is invariant under uniform rescaling of all
    # length-like quantities (residual homogeneous degree 1).
    "distance",
    "distance_var",
    "vertical_distance",
    "horizontal_distance",
    "vertical",
    "horizontal",
    "fixed",
    "scalar_equal",
    "points_coincident",
    "circle_radius",
    "lines_equal_length",
    "arc",
    "midpoint",
    "point_line_distance",
    "lines_at_angle",
    "points_at_angle",
    "line_tangent_circle",
    "circle_tangent_circle",
    "symmetric",
]


@pytest.mark.parametrize("name", _SCALE_INVARIANT_JAC)
def test_jacobian_scale_invariance(name):
    """Rescaling the whole sketch by s rescales residuals by s but leaves
    Jacobians unchanged (proptests.rs:244-292)."""
    spec = KERNELS[name]
    p0 = _default_params(spec)
    jac_of = lambda v, p: np.asarray(
        jax.jacfwd(lambda vv: spec.fn(vv, jnp.asarray(p))[0])(jnp.asarray(v))
    )
    for _ in range(5):
        v = _random_vars(spec, RNG)
        s = RNG.uniform(0.5, 3.0)
        # Scale only length-like params (angle sin/cos and tangency side
        # flags are dimensionless).
        if name in ("lines_at_angle", "points_at_angle", "line_tangent_circle",
                    "circle_tangent_circle"):
            p_scaled = p0
        else:
            p_scaled = p0 * s
        j1 = jac_of(v, p0)
        j2 = jac_of(v * s, p_scaled)
        assert np.allclose(j1, j2, atol=1e-6 * max(1.0, np.abs(j1).max())), (
            f"{name} not scale invariant at s={s}\n{j1}\n{j2}"
        )


def _sample_constraints():
    """One instance of every constraint kind over a shared pool of ids."""
    ids = ez.IdGenerator()
    pts = [DatumPoint.new(ids) for _ in range(4)]
    dist = DatumDistance(ids.next_id())
    circ0 = DatumCircle(center=pts[0], radius=DatumDistance(ids.next_id()))
    circ1 = DatumCircle(center=pts[1], radius=DatumDistance(ids.next_id()))
    arc = DatumCircularArc(center=pts[0], start=pts[1], end=pts[2])
    l0 = DatumLineSegment(pts[0], pts[1])
    l1 = DatumLineSegment(pts[2], pts[3])
    return [
        Constraint.LineTangentToCircle(l0, circ1, ez.LineSide.Left),
        Constraint.CircleTangentToCircle(circ0, circ1, ez.CircleSide.Exterior),
        Constraint.Distance(pts[0], pts[1], 2.0),
        Constraint.DistanceVar(pts[0], pts[1], dist),
        Constraint.VerticalDistance(pts[0], pts[1], 1.0),
        Constraint.HorizontalDistance(pts[0], pts[1], 1.0),
        Constraint.Vertical(l0),
        Constraint.Horizontal(l0),
        Constraint.LinesAtAngle(l0, l1, AngleKind.Other, Angle.from_degrees(30.0)),
        Constraint.Fixed(dist.id, 1.0),
        Constraint.ScalarEqual(circ0.radius.id, circ1.radius.id),
        Constraint.PointsCoincident(pts[0], pts[1]),
        Constraint.CircleRadius(circ0, 2.0),
        Constraint.LinesEqualLength(l0, l1),
        Constraint.ArcRadius(arc, 2.0),
        Constraint.Arc(arc),
        Constraint.Midpoint(l0, pts[2]),
        Constraint.PointLineDistance(pts[2], l0, 1.0),
        Constraint.VerticalPointLineDistance(pts[2], l0, 1.0),
        Constraint.HorizontalPointLineDistance(pts[2], l0, 1.0),
        Constraint.Symmetric(l0, pts[2], pts[3]),
        Constraint.PointArcCoincident(arc, pts[3]),
        Constraint.ArcLength(arc, 2.0),
        Constraint.ArcAngle(arc, Angle.from_degrees(45.0)),
        Constraint.PointsAtAngle(pts[0], pts[1], pts[2], AngleKind.Other,
                                 Angle.from_degrees(30.0)),
    ]


def test_all_25_variants_lower():
    cs = _sample_constraints()
    assert len(cs) == 25
    kinds = {c.kind for c in cs}
    assert len(kinds) == 25
    for c in cs:
        insts = c.lower()
        assert insts
        for inst in insts:
            spec = KERNELS[inst.kernel]
            assert len(inst.var_ids) == spec.nvars
            assert len(inst.params) == spec.nparams
        rows = c.nonzero_rows()
        assert len(rows) == c.residual_dim()


def test_nonzeroes_match_dependent_ids():
    """Union of per-row nonzero ids == union of kernel gather indices
    (proptests.rs:164-180)."""
    for c in _sample_constraints():
        from_rows = set()
        for row in c.nonzero_rows():
            from_rows.update(row)
        from_kernels = set()
        for inst in c.lower():
            from_kernels.update(inst.var_ids)
        assert from_rows == from_kernels, c.kind


def test_random_square_solves():
    """Randomized end-to-end: a distance-constrained segment from random
    guesses always converges to the right length (proptests.rs:295-330)."""
    for trial in range(10):
        g = RNG.uniform(-50, 50, size=4)
        target = float(RNG.uniform(0.5, 20.0))
        p = DatumPoint(0, 1)
        q = DatumPoint(2, 3)
        # Skip near-coincident guesses (degenerate distance direction).
        if math.hypot(g[0] - g[2], g[1] - g[3]) < 1e-3:
            continue
        reqs = [
            ConstraintRequest.highest_priority(ez.Constraint.Fixed(0, 0.0)),
            ConstraintRequest.highest_priority(ez.Constraint.Fixed(1, 0.0)),
            ConstraintRequest.highest_priority(ez.Constraint.Distance(p, q, target)),
        ]
        guesses = [(0, float(g[0])), (1, float(g[1])), (2, float(g[2])), (3, float(g[3]))]
        out = ez.solve(reqs, guesses, ez.Config())
        assert out.is_satisfied(), (trial, g, target)
        got = math.hypot(out.final_values[2], out.final_values[3])
        assert abs(got - target) < 1e-4
