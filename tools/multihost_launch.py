#!/usr/bin/env python3
"""Multi-host launcher for sharded solves.

The reference is single-threaded (SURVEY.md section 2: no distributed
anything); this framework's multi-device paths (``parallel.FleetSolver``,
``parallel.ShardedSchurSolver``) scale past one host with JAX's standard
multi-process runtime: run THIS SAME script once per host — one process
per host, which drives all of that host's cards — point every copy at the
same coordinator, and ``jax.distributed.initialize`` stitches the hosts'
cards into one global mesh. XLA's collectives ride the cards' own
interconnect inside a host and the network across hosts — there is no
custom transport to configure.

    # host 0 (also the coordinator):
    python tools/multihost_launch.py --coordinator 10.0.0.1:8476 \
        --num-processes 2 --process-id 0 --demo schur
    # host 1:
    python tools/multihost_launch.py --coordinator 10.0.0.1:8476 \
        --num-processes 2 --process-id 1 --demo schur

Give all three flags: nothing tells JAX of the cluster otherwise.
``--demo fleet`` runs the data-parallel fleet instead; ``--demo none``
just initializes and prints the global device topology (a connectivity
smoke test).

``--cpu N`` forces the CPU backend with N faked devices per process —
this makes the script integration-testable on a single machine by
launching two local processes against a localhost coordinator
(tests/test_multihost.py does exactly that); the same flag is handy for
dry-running a multi-host topology before using real cards.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0 (omit to auto-detect)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--demo", choices=["none", "fleet", "schur"], default="none")
    ap.add_argument("--sketches-per-chip", type=int, default=65536)
    ap.add_argument("--points-per-chip", type=int, default=256)
    ap.add_argument("--cpu", type=int, default=0, metavar="N",
                    help="force the CPU backend with N faked devices per "
                         "process (local multi-process testing)")
    args = ap.parse_args(argv)

    if args.cpu:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.cpu}"
        )

    import jax

    if args.cpu:
        # Pin the platform before any backend initializes.
        jax.config.update("jax_platforms", "cpu")

    kw = {}
    if args.coordinator:
        kw = dict(coordinator_address=args.coordinator,
                  num_processes=args.num_processes,
                  process_id=args.process_id)
    jax.distributed.initialize(**kw)

    import numpy as np
    from jax.sharding import Mesh

    import ezpz_jax  # noqa: F401  (x64 on)

    ezpz_jax.enable_compilation_cache()
    n_global = len(jax.devices())
    n_local = len(jax.local_devices())
    if jax.process_index() == 0:
        print(f"mesh: {jax.process_count()} hosts x {n_local} chips "
              f"= {n_global} devices ({jax.devices()[0].device_kind})")
    if args.demo == "none":
        return 0

    from ezpz_jax.config import Config
    from ezpz_jax.constraints import Constraint
    from ezpz_jax.datatypes import DatumLineSegment, DatumPoint
    from ezpz_jax.models.compiled import compile_system
    from ezpz_jax.parallel import FleetSolver, ShardedSchurSolver

    mesh_axis = "batch" if args.demo == "fleet" else "d"
    mesh = Mesh(np.array(jax.devices()), (mesh_axis,))

    if args.demo == "fleet":
        import jax.numpy as jnp

        p, q = DatumPoint(0, 1), DatumPoint(2, 3)
        cs = [
            Constraint.Vertical(DatumLineSegment(p, q)),
            Constraint.Fixed(p.x_id, 0.0),
            Constraint.Fixed(p.y_id, 0.0),
            Constraint.Distance(p, q, 4.0),
        ]
        system = compile_system(cs, n_vars=4)
        fleet = FleetSolver(system, mesh=mesh, config=Config())
        B = args.sketches_per_chip * n_global
        x0 = jnp.tile(jnp.asarray(np.array([0.3, -0.2, 0.8, 3.1])), (B, 1))
        out = fleet.solve(x0)  # warmup/compile
        t0 = time.perf_counter()
        out = fleet.solve(x0)
        jax.block_until_ready(out.x)
        dt = time.perf_counter() - t0
        if jax.process_index() == 0:
            print(f"fleet: {B:,} sketches in {dt * 1e3:.1f} ms "
                  f"({B / dt:,.0f} sketches/sec across {n_global} chips)")
        return 0

    # schur: one coupled chain spanning every chip in the global mesh.
    from ezpz_jax.fixtures import horizontal_chain

    constraints, x0 = horizontal_chain(args.points_per_chip * n_global)

    solver = ShardedSchurSolver(constraints, len(x0), mesh=mesh, config=Config())
    out = solver.solve(x0)  # warmup/compile
    t0 = time.perf_counter()
    out = solver.solve(x0)
    dt = time.perf_counter() - t0
    if jax.process_index() == 0:
        print(f"schur: {len(x0):,} vars, {out['n_boundary']} boundary, "
              f"{out['iterations']} LM iterations, converged={out['converged']}, "
              f"{dt * 1e3:.1f} ms/solve across {n_global} chips")
    return 0


if __name__ == "__main__":
    sys.exit(main())
