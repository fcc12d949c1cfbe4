#!/usr/bin/env python3
"""Benchmark suite mirroring the reference's criterion benches
(``ezpz/benches/solver_bench.rs:15-212``):

* ``solve_inconsistent``            — test-case solve, no metadata
* ``solve_nonsquare``               — test-case solve, no metadata
* ``solve_nonsquare_analysis``      — solve + freedom (DoF) analysis
* ``solve_two_rectangles``          — test-case solve, no metadata
* ``solve_two_rectangles_dependent``— API-built coupled squares (bench.rs:60-139)
* ``solve_massive[200|600]``        — regenerated massive fixture @ 50/150 lines,
                                      throughput in vars/sec (bench.rs:173-198)
* ``solve_massive_analysis[200]``   — massive @ 50 lines + DoF analysis

Each bench reports the mean wall time over ``--iters`` timed runs after a
warmup run (which also pays jit compilation, like criterion's warmup phase).
``--json`` emits one JSON line per bench for machine tracking (the analog of
the reference's CodSpeed CI integration).

Usage:
    python benches/solver_bench.py [--iters N] [--json] [--cpu] [--only NAME]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)


def _case_text(name: str) -> str:
    return open(os.path.join(ROOT, "tests", "cases", name, "problem.md")).read()


def _bench(fn, iters: int):
    fn()  # warmup: jit compile + first solve
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters


def bench_case(name: str, iters: int, analysis: bool = False):
    """``bench_case`` / ``bench_case_analysis`` (solver_bench.rs:15-55)."""
    from ezpz_jax.config import Config
    from ezpz_jax.textual import Problem

    cs = Problem.from_str(_case_text(name)).to_constraint_system()
    if analysis:
        return _bench(lambda: cs.solve_with_config_analysis(Config()), iters)
    return _bench(lambda: cs.solve_no_metadata(Config()), iters)


def bench_two_rectangles_dependent(iters: int):
    """Two squares sharing a corner point (solver_bench.rs:60-139)."""
    import ezpz_jax as ez

    reqs, guesses = _two_rectangles_dependent_problem()
    cfg = ez.Config()
    return _bench(lambda: ez.solve(reqs, guesses, cfg), iters)


def bench_massive(n_vars: int, iters: int, analysis: bool = False):
    """Regenerate the massive fixture at the requested size and solve it,
    like ``run_massive``'s `just regen-massive-test` shell-out
    (solver_bench.rs:173-186). Throughput metric: vars/sec."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from gen_massive import generate

    from ezpz_jax.config import Config
    from ezpz_jax.textual import Problem

    txt = generate(n_vars // 4)
    cs = Problem.from_str(txt).to_constraint_system()
    if analysis:
        return _bench(lambda: cs.solve_with_config_analysis(Config()), iters)
    return _bench(lambda: cs.solve_no_metadata(Config()), iters)


BENCHES = [
    ("solve_inconsistent", lambda it: bench_case("inconsistent", it)),
    ("solve_nonsquare", lambda it: bench_case("nonsquare", it)),
    ("solve_nonsquare_analysis", lambda it: bench_case("nonsquare", it, analysis=True)),
    ("solve_two_rectangles", lambda it: bench_case("two_rectangles", it)),
    ("solve_two_rectangles_dependent", bench_two_rectangles_dependent),
    ("solve_massive[200]", lambda it: bench_massive(200, it)),
    ("solve_massive[600]", lambda it: bench_massive(600, it)),
    ("solve_massive_analysis[200]", lambda it: bench_massive(200, it, analysis=True)),
]


# Cases for the --latency mode: the criterion per-case protocol measured
# BOTH ways — synchronous (every outcome materialized before the next
# dispatch: what one interactive solve costs, including one device->host
# transfer) and pipelined (streamed dispatch, one sync: what the device
# itself sustains).
LATENCY_CASES = ["inconsistent", "nonsquare", "two_rectangles",
                 "two_rectangles_dependent", "massive[200]", "massive[600]"]


def latency_case(name: str, iters: int):
    """Sync + pipelined mean seconds/solve for one latency case."""
    from ezpz_jax.config import Config
    from ezpz_jax.textual import Problem

    if name == "two_rectangles_dependent":
        from ezpz_jax.api import time_resolves

        reqs, guesses = _two_rectangles_dependent_problem()
        time_resolves(reqs, guesses, Config(), iters=1)  # warmup/compile
        sync = time_resolves(reqs, guesses, Config(), iters=iters)
        pipe = time_resolves(reqs, guesses, Config(), iters=iters, pipelined=True)
        return sync, pipe
    if name.startswith("massive["):
        sys.path.insert(0, os.path.join(ROOT, "tools"))
        from gen_massive import generate

        n_vars = int(name.split("[")[1].rstrip("]"))
        cs = Problem.from_str(generate(n_vars // 4)).to_constraint_system()
    else:
        cs = Problem.from_str(_case_text(name)).to_constraint_system()
    cs.solve()  # warmup: jit compile
    sync = cs.time_resolves(iters=iters)
    pipe = cs.time_resolves(iters=iters, pipelined=True)
    return sync, pipe


def _two_rectangles_dependent_problem():
    import ezpz_jax as ez

    ids = ez.IdGenerator()
    p0, p1, p2, p3 = (ez.DatumPoint.new(ids) for _ in range(4))
    p5, p6, p7 = (ez.DatumPoint.new(ids) for _ in range(3))
    line0_bottom = ez.DatumLineSegment(p0, p1)
    line0_right = ez.DatumLineSegment(p1, p2)
    line0_top = ez.DatumLineSegment(p2, p3)
    line0_left = ez.DatumLineSegment(p3, p0)
    line1_bottom = ez.DatumLineSegment(p2, p5)
    line1_right = ez.DatumLineSegment(p5, p6)
    line1_top = ez.DatumLineSegment(p6, p7)
    line1_left = ez.DatumLineSegment(p7, p2)
    constraints = [
        ez.Constraint.Fixed(p0.id_x(), 1.0),
        ez.Constraint.Fixed(p0.id_y(), 1.0),
        ez.Constraint.Horizontal(line0_bottom),
        ez.Constraint.Horizontal(line0_top),
        ez.Constraint.Vertical(line0_left),
        ez.Constraint.Vertical(line0_right),
        ez.Constraint.Distance(p0, p1, 4.0),
        ez.Constraint.Distance(p0, p3, 3.0),
        ez.Constraint.Horizontal(line1_bottom),
        ez.Constraint.Horizontal(line1_top),
        ez.Constraint.Vertical(line1_left),
        ez.Constraint.Vertical(line1_right),
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
    return reqs, guesses


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20, help="timed iterations per bench")
    ap.add_argument("--json", action="store_true", help="one JSON line per bench")
    ap.add_argument("--cpu", action="store_true", help="force the CPU backend")
    ap.add_argument("--only", default=None, help="substring filter on bench names")
    ap.add_argument("--latency", action="store_true",
                    help="per-case sync + pipelined single-solve latency")
    args = ap.parse_args(argv)

    import jax

    if args.cpu:
        # Override the platform before any backend initializes.
        jax.config.update("jax_platforms", "cpu")

    import ezpz_jax  # noqa: F401  (x64 on)
    from ezpz_jax import enable_compilation_cache

    enable_compilation_cache()

    if args.latency:
        backend = jax.default_backend()
        for name in LATENCY_CASES:
            if args.only and args.only not in name:
                continue
            sync, pipe = latency_case(name, args.iters)
            rec = {
                "case": name,
                "backend": backend,
                "sync_mean_us": round(sync * 1e6, 1),
                "sync_solves_per_sec": round(1.0 / sync, 1),
                "pipelined_mean_us": round(pipe * 1e6, 1),
                "pipelined_solves_per_sec": round(1.0 / pipe, 1),
                "iters": args.iters,
            }
            if args.json:
                print(json.dumps(rec))
            else:
                print(f"{name:32s} sync {sync * 1e6:10.1f} us  "
                      f"pipelined {pipe * 1e6:10.1f} us/solve")
        return 0

    rows = []
    for name, fn in BENCHES:
        if args.only and args.only not in name:
            continue
        dt = fn(args.iters)
        rows.append((name, dt))
        if args.json:
            rec = {"bench": name, "mean_us": round(dt * 1e6, 1),
                   "solves_per_sec": round(1.0 / dt, 1), "iters": args.iters}
            if name.startswith("solve_massive["):
                n_vars = int(name.split("[")[1].rstrip("]"))
                rec["vars_per_sec"] = round(n_vars / dt, 0)
            print(json.dumps(rec))
        else:
            extra = ""
            if name.startswith("solve_massive["):
                n_vars = int(name.split("[")[1].rstrip("]"))
                extra = f"  ({n_vars / dt:,.0f} vars/sec)"
            print(f"{name:36s} {dt * 1e6:10.1f} us/solve  "
                  f"{1.0 / dt:10.1f} solves/sec{extra}")

    if not rows:
        print("no benches matched", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
