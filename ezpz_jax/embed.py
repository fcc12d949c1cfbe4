"""Embedding smoke harness — the analog of the reference's WASM harness
(``ezpz-wasm/src/lib.rs:8-103``).

The reference embeds the solver in a browser via wasm-bindgen and exposes
three sanity entry points (``hello``, ``test_faer``, ``benchmark``) that a
JS page calls and times. This framework embeds in host
applications as a plain Python module (or over HTTP via ``ezpz_jax.serve``),
so the equivalent harness exposes the same three probes for any embedder to
smoke-test the install:

* ``hello()``           — returns 33: the module loaded (``lib.rs:9-11``);
* ``test_linalg()``     — exercises the linear-algebra backend the way
  ``test_faer`` pokes faer (``lib.rs:14-25``): solves a known SPD system
  through the LM loop's own Cholesky routine, verifies the solution, and
  returns 1.0 (raises if the backend is broken);
* ``benchmark()``       — solves the exact two-dependent-rectangles system
  the wasm harness solves (``lib.rs:28-103``) and returns the final values
  as a plain list, for the embedder to time in a loop (``main.js:8-15``).

Run directly for a self-timed report (the ``main.js`` analog):

    python -m ezpz_jax.embed
"""

from __future__ import annotations

from typing import List


def hello() -> int:
    """Module-load probe (``ezpz-wasm/src/lib.rs:9-11``)."""
    return 33


def test_linalg() -> float:
    """Linear-algebra-backend probe (``ezpz-wasm/src/lib.rs:14-25``).

    The reference pokes faer; here the probe actually exercises the solver's
    SPD path: build a known SPD system, solve it with ``ops.linalg.spd_solve``
    (the exact routine the LM loop factorizes with), verify the solution,
    and return 1.0 — so a broken Cholesky path fails here, not later inside
    production solves."""
    import jax.numpy as jnp

    import ezpz_jax  # noqa: F401  (x64 on)
    from ezpz_jax.ops.linalg import spd_solve

    a = jnp.array([[4.0, 1.0, 0.0], [1.0, 3.0, 1.0], [0.0, 1.0, 2.0]])
    x_true = jnp.array([1.0, -2.0, 3.0])
    x, fail = spd_solve(a, a @ x_true)
    if bool(fail) or float(jnp.max(jnp.abs(x - x_true))) > 1e-10:
        raise RuntimeError("SPD solve failed the embed probe")
    return 1.0


def benchmark() -> List[float]:
    """Solve the wasm harness's two-dependent-rectangles system
    (``ezpz-wasm/src/lib.rs:28-103``); returns the final variable values."""
    import ezpz_jax as ez

    ids = ez.IdGenerator()
    p0, p1, p2, p3 = (ez.DatumPoint.new(ids) for _ in range(4))
    p5, p6, p7 = (ez.DatumPoint.new(ids) for _ in range(3))

    constraints = [
        ez.Constraint.Fixed(p0.id_x(), 1.0),
        ez.Constraint.Fixed(p0.id_y(), 1.0),
        ez.Constraint.Horizontal(ez.DatumLineSegment(p0, p1)),
        ez.Constraint.Horizontal(ez.DatumLineSegment(p2, p3)),
        ez.Constraint.Vertical(ez.DatumLineSegment(p3, p0)),
        ez.Constraint.Vertical(ez.DatumLineSegment(p1, p2)),
        ez.Constraint.Distance(p0, p1, 4.0),
        ez.Constraint.Distance(p0, p3, 3.0),
        ez.Constraint.Horizontal(ez.DatumLineSegment(p2, p5)),
        ez.Constraint.Horizontal(ez.DatumLineSegment(p6, p7)),
        ez.Constraint.Vertical(ez.DatumLineSegment(p7, p2)),
        ez.Constraint.Vertical(ez.DatumLineSegment(p5, p6)),
        ez.Constraint.Distance(p2, p5, 4.0),
        ez.Constraint.Distance(p2, p7, 4.0),
    ]
    reqs = [ez.ConstraintRequest.highest_priority(c) for c in constraints]
    guesses = [
        (p0.id_x(), 1.0), (p0.id_y(), 1.0),
        (p1.id_x(), 4.5), (p1.id_y(), 1.5),
        (p2.id_x(), 4.0), (p2.id_y(), 3.5),
        (p3.id_x(), 1.5), (p3.id_y(), 3.0),
        (p5.id_x(), 5.5), (p5.id_y(), 3.5),
        (p6.id_x(), 5.0), (p6.id_y(), 4.5),
        (p7.id_x(), 2.5), (p7.id_y(), 4.0),
    ]
    out = ez.solve(reqs, guesses, ez.Config())
    return [float(v) for v in out.final_values]


def _main() -> int:
    """Self-timed report: the analog of the JS page timing 100 runs
    (``ezpz-wasm/main.js:1-16``)."""
    import time

    assert hello() == 33
    assert test_linalg() == 1.0
    vals = benchmark()  # warmup (jit compile)
    n = 100
    t0 = time.perf_counter()
    for _ in range(n):
        benchmark()
    dt = (time.perf_counter() - t0) / n
    print(f"hello() = 33, test_linalg() = 1.0, benchmark(): {len(vals)} values")
    print(f"mean over {n} runs: {dt * 1e6:.0f}us ({1.0 / dt:.0f} solves/sec)")
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
