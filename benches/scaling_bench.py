#!/usr/bin/env python3
"""Scaling-efficiency benchmark over a device mesh.

Measures weak scaling (fixed work per device) of both multi-device paths:

* ``fleet``: data-parallel batch of independent sketches (FleetSolver) —
  B = sketches_per_device x D, no collectives in the hot loop;
* ``schur``: one coupled chain system sharded across devices
  (ShardedSchurSolver) — vars_per_device x D variables, one psum of an
  (n_b, n_b) packet per LM iteration.

Efficiency(D) = t(1) / t(D) under weak scaling (ideal = 1.0). On real
cards this is the multi-card scaling metric; on a faked CPU mesh
(XLA_FLAGS=--xla_force_host_platform_device_count=N) the numbers validate
that the collective pattern compiles and stays iteration-count-flat, not
interconnect bandwidth.

Usage:
    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python benches/scaling_bench.py --devices 8
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


def _chain_system(n_points: int):
    from ezpz_jax.fixtures import horizontal_chain

    return horizontal_chain(n_points, x_spacing=1.1, x_offset=0.05, y_offset=0.07)


def bench_fleet(devices, per_device: int, reps: int, precision: str = "f64"):
    """``precision`` mirrors ``FleetSolver``."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    from ezpz_jax.config import Config
    from ezpz_jax.constraints import Constraint
    from ezpz_jax.datatypes import DatumLineSegment, DatumPoint
    from ezpz_jax.models.compiled import compile_system
    from ezpz_jax.parallel import FleetSolver

    p, q = DatumPoint(0, 1), DatumPoint(2, 3)
    cs = [
        Constraint.Vertical(DatumLineSegment(p, q)),
        Constraint.Fixed(p.x_id, 0.0),
        Constraint.Fixed(p.y_id, 0.0),
        Constraint.Distance(p, q, 4.0),
    ]
    x0 = np.array([0.3, -0.2, 0.8, 3.1])
    system = compile_system(cs, n_vars=4)
    batch_params = precision == "mixed"

    # Warm every device count first, then INTERLEAVE the timed reps
    # (d=1,2,4,8, d=1,2,4,8, ...) and take per-d medians: this host's
    # available CPU drifts 30-40% over minutes, and measuring d=1 a
    # minute before d=8 poisons the efficiency ratio; interleaving makes
    # the drift hit every d equally so the ratio cancels it.
    solvers = {}
    for d in sorted(set(devices)):
        mesh = Mesh(np.array(jax.devices()[:d]), ("batch",))
        fleet = FleetSolver(system, mesh=mesh, config=Config(),
                            batch_params=batch_params, precision=precision)
        B = per_device * d
        x0b = jnp.asarray(np.tile(x0, (B, 1)))
        pars = None
        if batch_params:
            pars = tuple(
                jnp.tile(jnp.asarray(np.asarray(b.par)), (B, 1, 1))
                for b in system.blocks)
        res = fleet.solve(x0b, pars) if batch_params else fleet.solve(x0b)
        assert bool(np.asarray(res.converged).all())
        solvers[d] = (fleet, x0b, pars, B)
    times = {d: [] for d in solvers}
    for _ in range(reps):
        for d, (fleet, x0b, pars, _B) in solvers.items():
            t0 = time.perf_counter()
            if batch_params:
                out = fleet.solve(x0b, pars)
            else:
                out = fleet.solve(x0b)
            jax.block_until_ready(out.x)
            times[d].append(time.perf_counter() - t0)
    results = {}
    for d, (_fleet, _x0b, _pars, B) in solvers.items():
        dt = sorted(times[d])[len(times[d]) // 2]
        results[d] = dict(batch=B, sec_per_solve=dt, sketches_per_sec=B / dt)
    return results


def bench_schur(devices, points_per_device: int, reps: int):
    import jax
    import numpy as np
    from jax.sharding import Mesh

    from ezpz_jax.config import Config
    from ezpz_jax.parallel import ShardedSchurSolver

    # Same interleaved-rep protocol as bench_fleet (see comment there).
    solvers = {}
    for d in sorted(set(devices)):
        constraints, x0 = _chain_system(points_per_device * d)
        mesh = Mesh(np.array(jax.devices()[:d]), ("d",))
        solver = ShardedSchurSolver(constraints, len(x0), mesh=mesh, config=Config())
        out = solver.solve(x0)  # warmup/compile
        assert out["converged"] and out["satisfied"].all(), out
        solvers[d] = (solver, x0, out)
    times = {d: [] for d in solvers}
    for _ in range(reps):
        for d, (solver, x0, _out) in solvers.items():
            t0 = time.perf_counter()
            solver.solve(x0)
            times[d].append(time.perf_counter() - t0)
    results = {}
    for d, (_solver, x0, out) in solvers.items():
        dt = sorted(times[d])[len(times[d]) // 2]
        results[d] = dict(
            n_vars=len(x0), sec_per_solve=dt, iterations=out["iterations"],
            n_boundary=out["n_boundary"],
        )
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=None)
    ap.add_argument(
        "--sweep", type=str, default=None,
        help="comma list of device counts, e.g. 1,2,4,8 — benchmarks the "
             "whole weak-scaling curve instead of just {1, --devices}",
    )
    ap.add_argument("--fleet-per-device", type=int, default=4096)
    ap.add_argument("--fleet-precision", default="f64",
                    choices=("f64", "mixed"))
    ap.add_argument("--schur-points-per-device", type=int, default=64)
    ap.add_argument("--no-schur", action="store_true")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)

    import jax

    import ezpz_jax  # noqa: F401  (x64 on)

    if args.sweep:
        devices = sorted({int(s) for s in args.sweep.split(",")} | {1})
    else:
        devices = sorted({1, args.devices or len(jax.devices())})
    D = max(devices)
    if len(jax.devices()) < D:
        print(f"error: need {D} devices, have {len(jax.devices())} "
              "(set XLA_FLAGS=--xla_force_host_platform_device_count)",
              file=sys.stderr)
        return 1

    fleet = bench_fleet(devices, args.fleet_per_device, args.reps,
                        precision=args.fleet_precision)
    schur = (None if args.no_schur else
             bench_schur(devices, args.schur_points_per_device, args.reps))

    import multiprocessing

    host_cores = multiprocessing.cpu_count()

    def effs(results):
        t1 = results[1]["sec_per_solve"]
        out = {}
        for d, r in results.items():
            td = r["sec_per_solve"]
            out[str(d)] = {
                # Real weak scaling: ideal t(D) == t(1). Only meaningful
                # when D devices are D real cards.
                "weak_scaling": round(t1 / td, 3),
                # Faked-mesh (fewer cores than devices) figure of merit:
                # the D simulated devices time-share the host, so perfect
                # sharding WITH ZERO overhead gives t(D) == D * t(1) and
                # serialization == 1.0. Values near 1.0 mean the shard_map
                # partitioning + collectives add no work beyond the D x
                # compute; on real cards that compute runs concurrently.
                "serialization": round(d * t1 / td, 3),
            }
        return out

    rec = {
        "metric": "weak_scaling_efficiency",
        "devices": devices,
        "host_cores": host_cores,
        "faked_mesh": host_cores < D,
        "fleet_path": args.fleet_precision,
        "fleet": {str(k): v for k, v in fleet.items()},
        "fleet_efficiency": effs(fleet),
        "backend": jax.default_backend(),
    }
    if schur is not None:
        rec["schur"] = {str(k): v for k, v in schur.items()}
        rec["schur_efficiency"] = effs(schur)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
