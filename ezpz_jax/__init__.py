"""ezpz_jax — a JAX-native 2D geometric constraint solver.

A from-scratch JAX/XLA implementation of the problem class solved by the
reference Rust solver (KittyCAD/ezpz): declare 2D geometry (points, lines,
circles, arcs), declare constraints between them (coincident, distance,
parallel, tangent, ...), provide initial guesses, and solve the resulting
sparse nonlinear least-squares system with Levenberg-Marquardt.

Architecture (accelerator-first, not a port):

* Constraints are *compiled* to padded per-constraint-type index/param arrays
  (``ezpz_jax.models.compiled.CompiledSystem``) instead of an enum interpreted
  row by row (reference: ``ezpz/src/solver.rs:318-440``).
* Residuals are pure vmapped kernels; Jacobians come from ``jax.jacfwd`` of
  those kernels (the reference property-tests analytic == finite-difference
  Jacobians, ``ezpz/src/tests/proptests.rs:188-234``, so autodiff matches).
* The normal equations (JtJ + lambda I) d = -Jt r are assembled scatter-free
  via segment sums and solved with batched dense Cholesky.
* The LM loop is a jit-compiled ``lax.while_loop`` with the reference's exact
  accept/reject and convergence semantics (``ezpz/src/solver/newton.rs:29-145``).
* Thousands of independent sketches batch with ``vmap`` on one device; giant
  systems shard over a ``jax.sharding.Mesh``.

Numerics default to float64 (x64 mode is enabled on import) to hit the
reference's 1e-8 residual tolerance.
"""

import os as _os

import jax as _jax

_jax.config.update("jax_enable_x64", True)

# Sanitizer analog (SURVEY.md section 5): the reference has no threads so no
# race detection to mirror; the numerical equivalent here is JAX's NaN
# debugger — EZPZ_DEBUG_NANS=1 makes every jit-compiled solve re-run
# op-by-op and raise at the FIRST operation that produces a NaN (instead of
# the NaN flowing into a rejected LM step), pinpointing the kernel at fault.
# Off by default: the solver's hot path uses NaN-on-non-SPD as its
# factorization-failure signal, so this mode is for debugging kernels, not
# production. EZPZ_DEBUG_INFS=1 is the matching Inf hook.
if _os.environ.get("EZPZ_DEBUG_NANS", "") not in ("", "0"):
    _jax.config.update("jax_debug_nans", True)
if _os.environ.get("EZPZ_DEBUG_INFS", "") not in ("", "0"):
    _jax.config.update("jax_debug_infs", True)

from .config import Config
from .constraints import (
    Constraint,
    ConstraintRequest,
    LineSide,
    CircleSide,
)
from .datatypes import (
    Angle,
    AngleKind,
    DatumPoint,
    DatumLineSegment,
    DatumCircle,
    DatumCircularArc,
    DatumDistance,
    Point,
    Circle,
    Arc,
    Component,
)
from .utils.ids import Id, IdGenerator
from .utils.warnings import Warning, WarningContent
from .utils.errors import (
    EzpzError,
    NonLinearSystemError,
    MissingGuess,
    WrongNumberGuesses,
    EmptySystemNotAllowed,
    TextualError,
)
from .outcomes import SolveOutcome, FailureOutcome, FreedomAnalysis, SolveOutcomeFreedomAnalysis
from .api import solve, solve_analysis


def _host_fingerprint() -> str:
    """8-hex digest of this host's CPU feature set (+ arch).

    XLA:CPU serializes AOT-compiled executables into the persistent cache
    with the COMPILE machine's feature baseline baked in; loading one on a
    host with different features is at best rejected with a warning and at
    worst a SIGILL/segfault inside the cache reader (observed: a full-suite
    crash in ``compilation_cache.get_executable_and_time`` on entries
    written by an avx512/amx host). Namespacing the cache directory by the
    host's own features makes cross-host loads structurally impossible.
    """
    import hashlib as _hashlib
    import platform as _platform

    tag = _platform.machine()
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith("flags"):
                    tag += " " + " ".join(sorted(line.split(":", 1)[1].split()))
                    break
    except OSError:
        pass
    return _hashlib.md5(tag.encode()).hexdigest()[:8]


_CHECKOUT = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compilation cache (opt-in).

    Compiled solver executables are keyed by topology; caching them makes
    process restarts warm-start instead of re-paying XLA compiles. Where
    ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already uses that directory
    and nothing is changed here. Otherwise the cache lives at the fixed
    in-checkout ``.jax_cache/host-<fingerprint>`` (see
    ``_host_fingerprint``: entries AOT-compiled on a machine with other CPU
    features are never loaded). Returns the cache directory in use.
    """
    env = _os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = _os.path.join(_CHECKOUT, ".jax_cache", "host-" + _host_fingerprint())
    _jax.config.update("jax_compilation_cache_dir", path)
    return path


__all__ = [
    "Config",
    "Constraint",
    "ConstraintRequest",
    "LineSide",
    "CircleSide",
    "Angle",
    "AngleKind",
    "DatumPoint",
    "DatumLineSegment",
    "DatumCircle",
    "DatumCircularArc",
    "DatumDistance",
    "Point",
    "Circle",
    "Arc",
    "Component",
    "Id",
    "IdGenerator",
    "Warning",
    "WarningContent",
    "EzpzError",
    "NonLinearSystemError",
    "MissingGuess",
    "WrongNumberGuesses",
    "EmptySystemNotAllowed",
    "TextualError",
    "SolveOutcome",
    "FailureOutcome",
    "FreedomAnalysis",
    "SolveOutcomeFreedomAnalysis",
    "solve",
    "solve_analysis",
]

__version__ = "0.5.0"
