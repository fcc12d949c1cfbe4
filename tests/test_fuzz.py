"""Fuzz harness: arbitrary constraint systems must never crash the solver.

Mirrors the reference's libfuzzer target (``fuzz/fuzz_targets/fuzz_target_1.rs``):
Arbitrary-derived constraint lists + sequential-id guesses -> ``solve()``
must not panic. Here: hypothesis-generated systems -> ``solve`` either
returns a SolveOutcome or raises the typed ``FailureOutcome``, never anything
else, and final values are always real floats (NaN allowed only if the
inputs were already pathological — the reference makes the same guarantee:
no panic, not no-NaN).
"""

import math
import os

import pytest
from hypothesis import example, given, settings, strategies as st

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

N_VARS = 8

ids = st.integers(min_value=0, max_value=N_VARS - 1)
vals = st.floats(min_value=-100, max_value=100, allow_nan=False, allow_infinity=False)


@st.composite
def points(draw):
    return DatumPoint(draw(ids), draw(ids))


@st.composite
def lines(draw):
    return DatumLineSegment(draw(points()), draw(points()))


@st.composite
def circles(draw):
    return DatumCircle(center=draw(points()), radius=DatumDistance(draw(ids)))


@st.composite
def arcs(draw):
    return DatumCircularArc(center=draw(points()), start=draw(points()), end=draw(points()))


@st.composite
def constraints(draw):
    kind = draw(st.integers(min_value=0, max_value=24))
    if kind == 0:
        return Constraint.LineTangentToCircle(draw(lines()), draw(circles()))
    if kind == 1:
        return Constraint.CircleTangentToCircle(draw(circles()), draw(circles()))
    if kind == 2:
        return Constraint.Distance(draw(points()), draw(points()), draw(vals))
    if kind == 3:
        return Constraint.DistanceVar(draw(points()), draw(points()), DatumDistance(draw(ids)))
    if kind == 4:
        return Constraint.VerticalDistance(draw(points()), draw(points()), draw(vals))
    if kind == 5:
        return Constraint.HorizontalDistance(draw(points()), draw(points()), draw(vals))
    if kind == 6:
        return Constraint.Vertical(draw(lines()))
    if kind == 7:
        return Constraint.Horizontal(draw(lines()))
    if kind == 8:
        return Constraint.LinesAtAngle(
            draw(lines()), draw(lines()), AngleKind.Other, Angle.from_degrees(draw(vals))
        )
    if kind == 9:
        return Constraint.Fixed(draw(ids), draw(vals))
    if kind == 10:
        return Constraint.ScalarEqual(draw(ids), draw(ids))
    if kind == 11:
        return Constraint.PointsCoincident(draw(points()), draw(points()))
    if kind == 12:
        return Constraint.CircleRadius(draw(circles()), draw(vals))
    if kind == 13:
        return Constraint.LinesEqualLength(draw(lines()), draw(lines()))
    if kind == 14:
        return Constraint.ArcRadius(draw(arcs()), draw(vals))
    if kind == 15:
        return Constraint.Arc(draw(arcs()))
    if kind == 16:
        return Constraint.Midpoint(draw(lines()), draw(points()))
    if kind == 17:
        return Constraint.PointLineDistance(draw(points()), draw(lines()), draw(vals))
    if kind == 18:
        return Constraint.VerticalPointLineDistance(draw(points()), draw(lines()), draw(vals))
    if kind == 19:
        return Constraint.HorizontalPointLineDistance(draw(points()), draw(lines()), draw(vals))
    if kind == 20:
        return Constraint.Symmetric(draw(lines()), draw(points()), draw(points()))
    if kind == 21:
        return Constraint.PointArcCoincident(draw(arcs()), draw(points()))
    if kind == 22:
        return Constraint.ArcLength(draw(arcs()), draw(vals))
    if kind == 23:
        return Constraint.ArcAngle(draw(arcs()), Angle.from_degrees(draw(vals)))
    return Constraint.PointsAtAngle(
        draw(points()), draw(points()), draw(points()),
        AngleKind.Other, Angle.from_degrees(draw(vals)),
    )


# Committed regression corpus — the analog of the reference's
# ``proptest-regressions/tests/proptests.txt``: pinned pathological inputs
# that replay on EVERY run without hypothesis's ephemeral ``.hypothesis/``
# database. These are the adversarial shapes the fuzzer hunts (degenerate
# geometry, self-referential datums, aliased ids, all-zero state); any
# future falsifying example hypothesis finds should be added here.
_Z = [0.0] * N_VARS
_P0 = DatumPoint(0, 1)
_L00 = DatumLineSegment(_P0, _P0)  # zero-length, self-referential
_ARC0 = DatumCircularArc(center=_P0, start=_P0, end=_P0)  # fully collapsed


# `just fuzz` raises the example count for long randomized runs.
@settings(max_examples=int(os.environ.get("EZPZ_FUZZ_EXAMPLES", "20")), deadline=None)
@given(
    cs=st.lists(constraints(), min_size=0, max_size=4),
    guesses=st.lists(vals, min_size=N_VARS, max_size=N_VARS),
)
@example(cs=[], guesses=_Z)
@example(cs=[Constraint.Distance(_P0, _P0, 1.0)], guesses=_Z)
@example(cs=[Constraint.ScalarEqual(3, 3)], guesses=_Z)
@example(cs=[Constraint.Vertical(_L00), Constraint.Horizontal(_L00)], guesses=_Z)
@example(
    cs=[Constraint.LineTangentToCircle(
        _L00, DatumCircle(center=_P0, radius=DatumDistance(0)))],
    guesses=_Z,
)
@example(
    cs=[Constraint.CircleTangentToCircle(
        DatumCircle(center=_P0, radius=DatumDistance(0)),
        DatumCircle(center=_P0, radius=DatumDistance(0)))],
    guesses=_Z,
)
@example(cs=[Constraint.Symmetric(_L00, _P0, _P0)], guesses=_Z)
@example(cs=[Constraint.PointArcCoincident(_ARC0, _P0)], guesses=_Z)
@example(cs=[Constraint.ArcLength(_ARC0, 0.0)], guesses=_Z)
@example(cs=[Constraint.Arc(_ARC0), Constraint.ArcRadius(_ARC0, -1.0)], guesses=_Z)
@example(
    cs=[Constraint.Midpoint(_L00, _P0),
        Constraint.PointLineDistance(_P0, _L00, -100.0)],
    guesses=_Z,
)
@example(
    # Conflicting fixes + an aliased distance: inconsistent AND degenerate.
    cs=[Constraint.Fixed(0, -100.0), Constraint.Fixed(0, 100.0),
        Constraint.DistanceVar(_P0, _P0, DatumDistance(0))],
    guesses=_Z,
)
@example(
    cs=[Constraint.PointsAtAngle(_P0, _P0, _P0, AngleKind.Other,
                                 Angle.from_degrees(0.0))],
    guesses=_Z,
)
def test_fuzz_solve_never_crashes(cs, guesses):
    reqs = [ConstraintRequest.highest_priority(c) for c in cs]
    g = [(i, guesses[i]) for i in range(N_VARS)]
    try:
        out = ez.solve(reqs, g, ez.Config())
    except ez.FailureOutcome:
        return  # typed failure is the allowed error path
    assert isinstance(out.iterations, int)
    assert 0 <= out.iterations <= 35
    assert len(out.final_values) == N_VARS
    for v in out.final_values:
        assert isinstance(v, float)
