"""Every float32 contraction on the mixed-precision paths asks for
``Precision.HIGHEST``: on the GPU an f32 dot_general left at the default
may run in TF32 (10-bit mantissa), which keeps the f64-verified residual
from ever reaching 1e-8. Checked on the traced jaxprs, sub-jaxprs
included (while/scan/cond bodies, shard_map)."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ezpz_jax  # noqa: F401
from ezpz_jax.batch import BatchSolver
from ezpz_jax.config import Config
from ezpz_jax.constraints import Constraint
from ezpz_jax.datatypes import DatumPoint
from ezpz_jax.models.compiled import compile_system

from .corpus import fixture_system

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benches"))
from coupled_bench import build_problem  # noqa: E402
from midsize_bench import rect_chain  # noqa: E402

HIGHEST = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)


def _subjaxprs(value):
    for v in (value if isinstance(value, (tuple, list)) else (value,)):
        if hasattr(v, "jaxpr") and hasattr(v, "consts"):  # ClosedJaxpr
            yield v.jaxpr
        elif hasattr(v, "eqns"):  # Jaxpr
            yield v


def f32_dots(jaxpr):
    """(dtype, precision) of every dot_general with an f32 operand."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            dts = {str(v.aval.dtype) for v in eqn.invars}
            if "float32" in dts:
                out.append(eqn.params.get("precision"))
        for p in eqn.params.values():
            for sub in _subjaxprs(p):
                out.extend(f32_dots(sub))
    return out


class _Captured(Exception):
    pass


def _jaxpr_of_call(obj, attr, call):
    """The jaxpr of ``obj.<attr>`` (a jitted callable) at the arguments
    ``call()`` passes it — traced only, never compiled."""
    fn = getattr(obj, attr)
    seen = {}

    def capture(*args):
        seen["jaxpr"] = jax.make_jaxpr(fn)(*args).jaxpr
        raise _Captured

    setattr(obj, attr, capture)
    with pytest.raises(_Captured):
        call()
    return seen["jaxpr"]


def _expander(npts):
    pts = [DatumPoint(2 * i, 2 * i + 1) for i in range(npts)]
    cons = [Constraint.Fixed(pts[0].x_id, 0.0),
            Constraint.Fixed(pts[0].y_id, 0.0)]
    cons += [Constraint.Distance(a, b, 1.0) for a, b in zip(pts, pts[1:])]
    cons += [Constraint.Distance(pts[i], pts[(7 * i + 3) % npts], 2.0)
             for i in range(npts) if (7 * i + 3) % npts != i]
    return compile_system(cons, n_vars=2 * npts), 0.1 * np.arange(2 * npts)


def _batch(system, x0):
    solver = BatchSolver(system, Config(), precision="mixed")
    return _jaxpr_of_call(solver, "_run", lambda: solver.solve(
        jnp.asarray(np.stack([x0, x0]))))


def _chain():
    cons, x0 = rect_chain(8)
    return compile_system(cons, n_vars=len(x0)), x0


def _block_schur(boundary):
    from ezpz_jax.parallel import BlockSchurSolver

    cons, x0 = build_problem(24)
    solver = BlockSchurSolver(cons, len(x0), precision="mixed", n_parts=4,
                              boundary_solver=boundary)
    solver._build()
    return _jaxpr_of_call(solver, "_solve_one", lambda: solver.solve(x0))


def _sharded_schur(boundary):
    from jax.sharding import Mesh

    from ezpz_jax.parallel import ShardedSchurSolver

    cons, x0 = build_problem(24)
    mesh = Mesh(np.array(jax.devices()[:2]), ("d",))
    solver = ShardedSchurSolver(cons, len(x0), mesh=mesh, precision="mixed",
                                boundary_solver=boundary)
    return _jaxpr_of_call(solver, "_sharded", lambda: solver.solve(x0))


def _hier(boundary):
    from jax.sharding import Mesh

    from ezpz_jax.parallel import ShardedBlockSchurSolver

    cons, x0 = build_problem(24)
    mesh = Mesh(np.array(jax.devices()[:2]), ("d",))
    solver = ShardedBlockSchurSolver(cons, len(x0), n_parts=4, mesh=mesh,
                                     precision="mixed",
                                     boundary_solver=boundary)
    solver._build()
    return _jaxpr_of_call(solver, "_sharded", lambda: solver.solve(x0))


PATHS = {
    # BatchSolver, one per normal-equation tier (batch._pick_spd).
    "batch-band-massive": lambda: _batch(*fixture_system(
        "massive_parallel_system")),
    "batch-band-chain": lambda: _batch(*_chain()),
    "batch-colsweep": lambda: _batch(*_expander(20)),
    "batch-dense": lambda: _batch(*_expander(40)),
    "block-schur-dense": lambda: _block_schur("dense"),
    "block-schur-cg": lambda: _block_schur("cg"),
    "block-schur-banded": lambda: _block_schur("banded"),
    "sharded-schur-dense": lambda: _sharded_schur("dense"),
    "sharded-block-schur-cg": lambda: _hier("cg"),
}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_mixed_f32_contractions_are_highest(path):
    precisions = f32_dots(PATHS[path]())
    assert precisions, "no f32 contraction traced: the probe missed the path"
    assert all(p == HIGHEST for p in precisions), precisions


def test_f32_dots_sees_an_unannotated_contraction():
    """The walker itself: a bare f32 matmul inside a while body is found
    and reported without a precision."""
    def f(a):
        return jax.lax.while_loop(lambda c: c[1] < 2,
                                  lambda c: (c[0] @ c[0], c[1] + 1),
                                  (a, 0))[0]

    precisions = f32_dots(jax.make_jaxpr(f)(jnp.eye(2, dtype=jnp.float32)).jaxpr)
    assert precisions == [None]
