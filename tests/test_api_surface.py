"""Public-API stability snapshot — the analog of the
reference's semver-checks CI job (`/root/reference/.github/workflows/
CI.yml`, cargo-semver-checks): the exported surface and the signatures
of the two entry points are pinned, so an accidental removal / rename /
parameter change fails CI instead of breaking downstream users.

To CHANGE the surface intentionally, update the snapshot here and note
the break in CHANGELOG.md (that is the semver bump).
"""

import inspect

import ezpz_jax


# The v0 public surface, frozen. Additions are allowed (append here);
# removals or renames are semver breaks.
PUBLIC_SURFACE = [
    "Angle",
    "AngleKind",
    "Arc",
    "Circle",
    "CircleSide",
    "Component",
    "Config",
    "Constraint",
    "ConstraintRequest",
    "DatumCircle",
    "DatumCircularArc",
    "DatumDistance",
    "DatumLineSegment",
    "DatumPoint",
    "EmptySystemNotAllowed",
    "EzpzError",
    "FailureOutcome",
    "FreedomAnalysis",
    "Id",
    "IdGenerator",
    "LineSide",
    "MissingGuess",
    "NonLinearSystemError",
    "Point",
    "SolveOutcome",
    "SolveOutcomeFreedomAnalysis",
    "TextualError",
    "Warning",
    "WarningContent",
    "WrongNumberGuesses",
    "solve",
    "solve_analysis",
]

# The 25 reference constraint constructors (constraints.rs:37-93) plus
# the 5 composites (composite.rs:9-62) — each must stay constructible.
CONSTRAINT_CONSTRUCTORS = [
    "LineTangentToCircle", "CircleTangentToCircle", "Distance",
    "DistanceVar", "VerticalDistance", "HorizontalDistance", "Vertical",
    "Horizontal", "LinesAtAngle", "Fixed", "ScalarEqual",
    "PointsCoincident", "CircleRadius", "LinesEqualLength", "ArcRadius",
    "Arc", "Midpoint", "PointLineDistance", "VerticalPointLineDistance",
    "HorizontalPointLineDistance", "Symmetric", "PointArcCoincident",
    "ArcLength", "ArcAngle", "PointsAtAngle",
    # composites
    "lines_parallel", "lines_perpendicular", "point_bisects_arc",
    "parallel_lines_distance", "circle_arc_coincident",
]


def test_public_surface_is_stable():
    assert sorted(ezpz_jax.__all__) == sorted(PUBLIC_SURFACE)
    for name in PUBLIC_SURFACE:
        assert hasattr(ezpz_jax, name), f"__all__ exports missing {name}"


def test_solve_signatures_are_stable():
    """The entry-point parameter lists are part of the contract
    (`ezpz/src/lib.rs:80-87,134-144`)."""
    sig = inspect.signature(ezpz_jax.solve)
    assert list(sig.parameters) == ["reqs", "initial_guesses", "config"]
    sig_a = inspect.signature(ezpz_jax.solve_analysis)
    assert list(sig_a.parameters) == ["reqs", "initial_guesses", "config"]
    # config stays optional on both
    assert sig.parameters["config"].default is not inspect.Parameter.empty
    assert sig_a.parameters["config"].default is not inspect.Parameter.empty


def test_constraint_constructors_are_stable():
    for name in CONSTRAINT_CONSTRUCTORS:
        assert hasattr(ezpz_jax.Constraint, name), name
        assert callable(getattr(ezpz_jax.Constraint, name)), name


def test_config_fields_are_stable():
    """The reference Config surface (solver.rs:33-81) + documented
    extensions must keep their builder fields."""
    c = ezpz_jax.Config()
    for field in ("max_iterations", "residual_tolerance",
                  "step_tolerance", "initial_lambda"):
        assert hasattr(c, field), field


def test_outcome_fields_are_stable():
    """SolveOutcome's reported fields (solve_outcome.rs:12-26)."""
    import numpy as np

    p, q = ezpz_jax.DatumPoint(0, 1), ezpz_jax.DatumPoint(2, 3)
    reqs = [
        ezpz_jax.ConstraintRequest.highest_priority(
            ezpz_jax.Constraint.Fixed(0, 0.0)),
        ezpz_jax.ConstraintRequest.highest_priority(
            ezpz_jax.Constraint.Fixed(1, 0.0)),
        ezpz_jax.ConstraintRequest.highest_priority(
            ezpz_jax.Constraint.Distance(p, q, 5.0)),
    ]
    out = ezpz_jax.solve(
        reqs, [(0, 0.0), (1, 0.0), (2, 3.1), (3, 3.9)])
    for field in ("final_values", "unsatisfied", "iterations",
                  "converged", "priority_solved", "warnings"):
        assert hasattr(out, field), field
    assert out.converged
    assert np.isclose(np.hypot(out.final_values[2], out.final_values[3]),
                      5.0)
