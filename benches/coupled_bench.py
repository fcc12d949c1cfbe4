"""Coupled-system benchmark: the reference capability the block-diagonal
headline does NOT cover.

The reference's massive fixture decomposes into independent 4-var sketches;
its OTHER capability is one big genuinely-coupled sparse system through
faer's sparse LLT (``ezpz/src/solver/newton.rs:87-102``). This benchmark
solves the `coupled` generator's chain (``tools/gen_massive.py N coupled``:
N vertical lines, neighbors chained by lines_equal_length — NOT
block-diagonal) with ``BlockSchurSolver`` (single-device partitioned
Schur), batched over copies, verified at the f64 1e-8 inf-norm residual.

Prints one JSON line. Use --out to also write an artifact file.

    python benches/coupled_bench.py                 # whatever device jax picks
    python benches/coupled_bench.py --cpu --lines 100 --copies 4
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tools"))

# Dispatches per sync in the amortized protocols.
CHAIN = 4


def build_problem(lines: int):
    import numpy as np

    from gen_massive import generate_coupled

    from ezpz_jax.textual import Problem

    cs = Problem.from_str(generate_coupled(lines)).to_constraint_system()
    constraints = [r.constraint for r in cs.constraints]
    x0 = np.zeros(len(cs.initial_guesses))
    for vid, val in cs.initial_guesses:
        x0[vid] = val
    return constraints, x0


def run(lines: int = 600, copies: int = 64, precision: str = "mixed",
        reps: int = 5, n_parts=None, boundary_solver: str = "dense",
        latency: bool = False) -> dict:
    import numpy as np
    import jax
    import jax.numpy as jnp

    from ezpz_jax.parallel import BlockSchurSolver

    constraints, x0 = build_problem(lines)
    n_vars = len(x0)
    solver = BlockSchurSolver(constraints, n_vars, precision=precision,
                              n_parts=n_parts, boundary_solver=boundary_solver)
    x0s = jnp.tile(jnp.asarray(x0), (copies, 1))

    # Warmup/compile + correctness gate.
    res, sat = solver.solve_batch(x0s)
    ok = bool(np.asarray(res.converged).all())
    sat_ok = bool(np.asarray(sat).all())
    iters = int(np.asarray(res.iterations).max())
    rinf = float(jnp.max(jnp.abs(res.residual)))
    if not (ok and sat_ok):
        return {"error": "did not converge/satisfy", "converged": ok,
                "satisfied": sat_ok}

    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        r, _s = solver.solve_batch(x0s)
        r.x.block_until_ready()
        times.append(time.perf_counter() - t0)
    dt = sorted(times)[len(times) // 2]

    # Amortized pipeline rate (the headline, as in bench.py/midsize):
    # CHAIN dispatches behind ONE final scalar sync — the steady-state
    # device rate.
    ctimes = []
    for _ in range(reps):
        t0 = time.perf_counter()
        acc = None
        for _ in range(CHAIN):
            r, _s = solver.solve_batch(x0s)
            s_ = jnp.sum(r.x)
            acc = s_ if acc is None else acc + s_
        acc.block_until_ready()
        ctimes.append(time.perf_counter() - t0)
    cdt = sorted(ctimes)[len(ctimes) // 2]

    # batch=1 latency: one synchronous coupled solve (warm), the
    # interactive-use complement of the batched throughput number —
    # plus its PIPELINED variant (chained single-solve dispatches, one
    # final sync), which excludes the per-solve host transfer the sync
    # number pays (ezpz-cli/src/main.rs:96-100).
    lat_us = lat_pipelined_us = None
    if latency:
        import jax.numpy as jnp

        solver.solve(x0)  # compile the unbatched executable
        lts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            solver.solve(x0)
            lts.append(time.perf_counter() - t0)
        lat_us = round(sorted(lts)[len(lts) // 2] * 1e6, 1)
        # Pipelined: drive the underlying jitted executable directly
        # (solver.solve materializes every output to host, forcing a
        # sync per call); chain dispatches, sync once on a scalar.
        if solver._solve_one is not None:
            c2 = solver.config
            plts = []
            x0j = jnp.asarray(x0)
            for _ in range(reps):
                t0 = time.perf_counter()
                acc = None
                for _ in range(CHAIN):
                    res, _sat = solver._solve_one(
                        x0j, c2.residual_tolerance, c2.step_tolerance,
                        c2.initial_lambda)
                    s = jnp.sum(res.x)
                    acc = s if acc is None else acc + s
                acc.block_until_ready()
                plts.append(time.perf_counter() - t0)
            lat_pipelined_us = round(
                sorted(plts)[len(plts) // 2] / CHAIN * 1e6, 1)

    return {
        "metric": "coupled_system_solves_per_sec",
        "value": round(CHAIN * copies / cdt, 2),
        "unit": "solves/sec",
        "sync_solves_per_sec": round(copies / dt, 2),
        "chain": CHAIN,
        "batch1_latency_us": lat_us,
        "batch1_latency_pipelined_us": lat_pipelined_us,
        # Report the RESOLVED choice ("auto" picks structurally at build).
        "boundary_solver": solver.boundary_solver,
        "detail": {
            "system": f"{n_vars} vars / {len(constraints)} eqs coupled chain"
                      f" x {copies} copies (NOT block-diagonal)",
            "precision": precision + " (residual verified in float64)",
            "residual_tolerance": 1e-8,
            "final_residual_inf": rinf,
            "lm_iterations": iters,
            "n_parts": solver.P,
            "n_boundary": solver.n_b,
            "ms_per_batch": round(dt * 1e3, 1),
            "amortized_ms_per_batch": round(cdt / CHAIN * 1e3, 1),
            "device": {"platform": jax.devices()[0].platform,
                       "kind": jax.devices()[0].device_kind,
                       "count": len(jax.devices())},
        },
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lines", type=int, default=600)
    ap.add_argument("--copies", type=int, default=64)
    ap.add_argument("--precision", choices=["mixed", "f64"], default="mixed")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--n-parts", type=int, default=None)
    ap.add_argument("--boundary", choices=["dense", "cg", "banded", "auto"],
                    default="dense")
    ap.add_argument("--latency", action="store_true",
                    help="also measure batch=1 synchronous latency")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", default=None, help="also write JSON artifact here")
    args = ap.parse_args(argv)

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import ezpz_jax

    ezpz_jax.enable_compilation_cache()
    out = run(args.lines, args.copies, args.precision, args.reps,
              n_parts=args.n_parts, boundary_solver=args.boundary,
              latency=args.latency)
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0 if "error" not in out else 1


if __name__ == "__main__":
    sys.exit(main())
