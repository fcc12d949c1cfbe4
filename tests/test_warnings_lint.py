"""Unit tests for the static lint (``ezpz/src/warnings.rs:89-155``) — every
threshold branch, including the exact EPSILON boundary. (These branches were
found untested by a tools/mutate.py run: 180/360/+-90 constants and the
nearly_eq comparison all survived mutation.)
"""

from ezpz_jax.constraints import Constraint
from ezpz_jax.datatypes import Angle, AngleKind, DatumLineSegment, DatumPoint
from ezpz_jax.utils.warnings import EPSILON, Warning, WarningKind, lint


def _lines_at(deg: float) -> Constraint:
    line = DatumLineSegment(DatumPoint(0, 1), DatumPoint(2, 3))
    return Constraint.LinesAtAngle(line, line, AngleKind.Other,
                                   Angle.from_degrees(deg))


def _lint_one(deg: float):
    return lint([(7, _lines_at(deg))])


def test_parallel_thresholds():
    """0, 180, and 360 degrees all suggest Parallel (warnings.rs:38-41)."""
    for deg in (0.0, 180.0, 360.0, 360.00005, -0.00005, 179.99996):
        ws = _lint_one(deg)
        assert len(ws) == 1, deg
        assert ws[0].content is WarningKind.SHOULD_BE_PARALLEL, deg
        assert ws[0].about_constraint == 7


def test_perpendicular_thresholds():
    for deg in (90.0, -90.0, 90.00005, -89.99996):
        ws = _lint_one(deg)
        assert len(ws) == 1, deg
        assert ws[0].content is WarningKind.SHOULD_BE_PERPENDICULAR, deg


def test_ordinary_angles_do_not_warn():
    for deg in (45.0, 91.0, 178.0, 270.0, -45.0, 10.0):
        assert _lint_one(deg) == [], deg


def test_epsilon_boundary_is_strict():
    """nearly_eq uses a STRICT < 1e-4 comparison (lib.rs:43); exactly 1e-4
    away does not warn, just inside does. Literal values on purpose — the
    boundary itself is reference-pinned, not relative to our constant."""
    assert EPSILON == 1e-4
    assert _lint_one(90.0 + 1e-4) == []
    assert _lint_one(90.0 + 5e-5) != []
    assert _lint_one(0.0 + 1e-4) == []
    assert _lint_one(0.0 + 5e-5) != []
    # An angle 5e-4 off is OUTSIDE the 1e-4 band: must stay silent.
    assert _lint_one(90.0 + 5e-4) == []
    assert _lint_one(0.0 + 5e-4) == []


def test_non_other_angle_kinds_skipped():
    """Parallel/Perpendicular AngleKind variants are what the lint suggests
    switching TO — they never themselves warn."""
    line = DatumLineSegment(DatumPoint(0, 1), DatumPoint(2, 3))
    for kind in (AngleKind.Parallel, AngleKind.Perpendicular):
        c = Constraint.LinesAtAngle(line, line, kind, None)
        assert lint([(0, c)]) == []
        # Even with an angle value attached, a non-Other kind never lints.
        c2 = Constraint.LinesAtAngle(line, line, kind, Angle.from_degrees(0.0))
        assert lint([(0, c2)]) == []


def test_non_angle_constraints_skipped():
    assert lint([(0, Constraint.Fixed(0, 1.0))]) == []


def test_mixed_list_reports_both_ids():
    """The reference's suggests_parallel_and_perpendicular test
    (warnings.rs:106-141): ids 7 and 9, in order."""
    ws = lint([(7, _lines_at(360.00005)), (9, _lines_at(-90.0))])
    assert [w.about_constraint for w in ws] == [7, 9]
    assert ws[0].content is WarningKind.SHOULD_BE_PARALLEL
    assert ws[1].content is WarningKind.SHOULD_BE_PERPENDICULAR


def test_display_formats_are_human_friendly():
    """warnings.rs:143-153."""
    assert "degenerate" in str(Warning(None, WarningKind.DEGENERATE))
    assert "Parallel" in str(
        Warning(0, WarningKind.SHOULD_BE_PARALLEL, angle_degrees=0.0))
    assert "Perpendicular" in str(
        Warning(0, WarningKind.SHOULD_BE_PERPENDICULAR, angle_degrees=90.0))
