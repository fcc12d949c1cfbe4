#!/usr/bin/env python3
"""Mid-size-topology fleet benchmark.

The headline bench solves fleets of 4-var blocks; real sketches are bigger.
This measures fleets of chained-rectangle sketches (and 2-D grids) at
several topology sizes on the XLA mixed path, through whichever
normal-equation tier ``BatchSolver`` picks (``batch._pick_spd``):

* ``rect_chain[2]`` — 14 constraint instances, 14 vars: unrolled Crout;
* ``rect_chain[4]`` — 26 instances, 26 vars: past the 24-var unroll;
* ``rect_chain[8]`` — 50 instances, 50 vars: ditto, larger;
* ``--sizes 11 16 24 5x5`` — arbitrary chain sizes or RXxRY grids.

Protocol matches bench.py: one sync per rep, median over reps, plus an
AMORTIZED rate (``CHAIN`` dispatches per sync) — the steady-state
pipeline rate, the closest analog of the reference CLI's in-process hot
loop.

Usage:
    python benches/midsize_bench.py [--copies 32768] [--reps 5] [--cpu]
                                    [--sizes 2 4 8]
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

# Dispatches per sync in the amortized protocol.
CHAIN = 4


def rect_chain(R: int):
    """R rectangles chained corner-to-corner (the two_rectangles_dependent
    construction, solver_bench.rs:60-139, generalized). Returns
    (constraints, x0_guess). 6R+2 dim-1 constraints, 2(3R+1) vars."""
    import numpy as np

    import ezpz_jax as ez

    ids = ez.IdGenerator()
    pts = [ez.DatumPoint.new(ids) for _ in range(3 * R + 1)]
    seg = ez.DatumLineSegment
    cons = [
        ez.Constraint.Fixed(pts[0].id_x(), 1.0),
        ez.Constraint.Fixed(pts[0].id_y(), 1.0),
    ]
    guess = [(1.0, 1.0)]
    for k in range(R):
        s, u, v, w = pts[3 * k], pts[3 * k + 1], pts[3 * k + 2], pts[3 * k + 3]
        cons += [
            ez.Constraint.Horizontal(seg(s, u)),   # bottom
            ez.Constraint.Vertical(seg(u, v)),     # right
            ez.Constraint.Horizontal(seg(v, w)),   # top
            ez.Constraint.Vertical(seg(w, s)),     # left
            ez.Constraint.Distance(s, u, 4.0),
            ez.Constraint.Distance(s, w, 3.0),
        ]
        sx, sy = guess[3 * k]
        guess += [(sx + 3.5, sy + 0.5),   # u ~ bottom-right
                  (sx + 4.2, sy + 3.4),   # v ~ top-right (next rect's s)
                  (sx + 0.5, sy + 2.6)]   # w ~ top-left
    x0 = np.array([c for p in guess for c in p])
    return cons, x0


def rect_grid(RX: int, RY: int):
    """An RX x RY grid of unit cells pinned at one corner — 2-D coupling
    (the chain benches are 1-D): every horizontal edge is Horizontal +
    Distance 1, every vertical edge Vertical + Distance 1. Rigid up to the
    pinned corner; RCM orders the grid to bandwidth ~ 2*min(RX,RY)."""
    import numpy as np

    import ezpz_jax as ez

    ids = ez.IdGenerator()
    P = [[ez.DatumPoint.new(ids) for _ in range(RY + 1)]
         for _ in range(RX + 1)]
    seg = ez.DatumLineSegment
    cons = [ez.Constraint.Fixed(P[0][0].id_x(), 0.0),
            ez.Constraint.Fixed(P[0][0].id_y(), 0.0)]
    rng = np.random.default_rng(3)
    n = 2 * (RX + 1) * (RY + 1)
    x0 = np.zeros(n)
    for i in range(RX + 1):
        for j in range(RY + 1):
            x0[P[i][j].id_x()] = i + rng.normal(0, 0.05)
            x0[P[i][j].id_y()] = j + rng.normal(0, 0.05)
            if i < RX:
                cons.append(ez.Constraint.Horizontal(seg(P[i][j], P[i + 1][j])))
                cons.append(ez.Constraint.Distance(P[i][j], P[i + 1][j], 1.0))
            if j < RY:
                cons.append(ez.Constraint.Vertical(seg(P[i][j], P[i][j + 1])))
                cons.append(ez.Constraint.Distance(P[i][j], P[i][j + 1], 1.0))
    return cons, x0


def bench_fleet(R, copies: int, reps: int):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ezpz_jax.batch import BatchSolver
    from ezpz_jax.config import Config
    from ezpz_jax.models.compiled import compile_system

    if isinstance(R, str) and "x" in R:
        rx, ry = (int(t) for t in R.split("x"))
        cons, x0 = rect_grid(rx, ry)
        topo = f"rect_grid[{R}]"
    else:
        cons, x0 = rect_chain(int(R))
        topo = f"rect_chain[{R}]"
    system = compile_system(cons, n_vars=len(x0))
    n_instances = sum(int(b.idx.shape[0]) for b in system.blocks)

    solver = BatchSolver(system, Config(), batch_params=True,
                         precision="mixed")
    x0b = jnp.tile(jnp.asarray(x0), (copies, 1))
    pars = tuple(
        jnp.tile(jnp.asarray(np.asarray(b.par)), (copies, 1, 1))
        for b in system.blocks
    )

    def run_once():
        out = solver.solve(x0b, pars)
        out.x.block_until_ready()
        return out

    out = run_once()  # warmup + correctness gate
    conv = bool(np.asarray(out.converged).all())
    sat = bool(np.asarray(out.satisfied).all())
    r, _deg = jax.vmap(lambda x, *p: system.residual_and_flags(x, p))(
        jnp.asarray(out.x, jnp.float64), *pars)
    rmax = float(jnp.max(jnp.abs(r)))

    # Protocol 1 (sync): one sync per batch.
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run_once()
        times.append(time.perf_counter() - t0)
    dt = sorted(times)[len(times) // 2]

    # Protocol 2 (amortized): CHAIN back-to-back batch dispatches with ONE
    # final sync over a scalar that depends on every output — the
    # steady-state pipeline rate, the closest analog of the reference
    # CLI's 100-resolve hot loop (ezpz-cli/src/main.rs:96-100).
    ctimes = []
    for _ in range(reps):
        t0 = time.perf_counter()
        acc = None
        for _ in range(CHAIN):
            s = solver.solve(x0b, pars).x.sum()
            acc = s if acc is None else acc + s
        acc.block_until_ready()
        ctimes.append(time.perf_counter() - t0)
    cdt = sorted(ctimes)[len(ctimes) // 2]

    return {
        "topology": topo,
        "n_instances": n_instances,
        "n_vars": system.n_vars,
        "copies": copies,
        "path": "xla_mixed",
        "solves_per_sec": round(copies / dt, 1),
        "us_per_solve": round(dt / copies * 1e6, 3),
        "amortized_solves_per_sec": round(CHAIN * copies / cdt, 1),
        "amortized_us_per_solve": round(cdt / (CHAIN * copies) * 1e6, 4),
        "chain": CHAIN,
        "converged": conv,
        "satisfied": sat,
        "residual_f64_max": rmax,
        "reps": reps,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--copies", type=int, default=32768)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--only", default=None, help="substring filter")
    ap.add_argument("--sizes", nargs="+", default=["2", "4", "8"],
                    help="rect_chain sizes R (6R+2 instances, 6R+2 vars), "
                         "or RXxRY for a 2-D rect_grid (e.g. 5x5)")
    args = ap.parse_args(argv)

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import ezpz_jax

    ezpz_jax.enable_compilation_cache()

    for R in args.sizes:
        kind = "rect_grid" if "x" in R else "rect_chain"
        name = f"{kind}[{R}]"
        if args.only and args.only not in name:
            continue
        rec = bench_fleet(R, args.copies, args.reps)
        rec["name"] = name
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
