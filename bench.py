"""Headline benchmark: massive_parallel_system solve throughput.

Solves M independent copies of the reference's massive_parallel_system
fixture (600 blocks x 4 vars = 2400 vars, 2400 eqs) per jitted call, batched
along the component axis (600*M sketches), in float64 to the reference's
1e-8 residual tolerance. Prints one JSON line:

    {"metric": ..., "value": N, "unit": "solves/sec", "vs_baseline": N}

Baseline: the reference solves this fixture at 339 solves/sec on a dev
machine (README.md:37-41; 2,943 us/solve, 2 LM iterations).
"""

import json
import os
import sys
import time

BASELINE_SOLVES_PER_SEC = 339.0
# Dispatches per sync in the amortized protocol.
CHAIN = 4


def main():
    import jax
    import jax.numpy as jnp
    import numpy as np

    import ezpz_jax  # noqa: F401  (x64 on)

    # Persistent compilation cache: repeated bench runs warm-start instead
    # of paying the XLA compiles again.
    ezpz_jax.enable_compilation_cache()
    from ezpz_jax.config import Config
    from ezpz_jax.models.blocks import build_buckets
    from ezpz_jax.textual import Problem

    here = os.path.dirname(os.path.abspath(__file__))
    fixture = os.path.join(here, "tests", "cases", "massive_parallel_system", "problem.md")
    txt = open(fixture).read()
    cs = Problem.from_str(txt).to_constraint_system()
    constraints = [r.constraint for r in cs.constraints]
    x0 = np.zeros(len(cs.initial_guesses))
    for vid, val in cs.initial_guesses:
        x0[vid] = val
    n_vars = len(x0)

    # Decompose the fixture into its component blocks and batch M copies of
    # the whole system along the component axis.
    buckets = build_buckets(constraints, n_vars)
    M = int(os.environ.get("BENCH_COPIES", "8192"))

    # "f64" is the reference-exact LM loop; "mixed" is f32 LM +
    # f64-residual refinement (solve_lm_mixed), verified at the same 1e-8
    # inf-norm tolerance in f64. Buckets dispatch as separate executables.
    precision = os.environ.get("BENCH_PRECISION", "f64")
    from ezpz_jax.batch import BatchSolver

    reps = int(os.environ.get("BENCH_REPS", "5"))
    solvers = []
    for bucket in buckets:
        solver = BatchSolver(bucket.system, Config(), batch_params=True,
                             precision=precision)
        # Tile ON DEVICE: upload the per-component template (KBs) and tile
        # with jnp instead of uploading the pre-tiled host arrays.
        x0b = jnp.tile(jnp.asarray(x0[bucket.var_index]), (M, 1))
        pars = tuple(jnp.tile(jnp.asarray(p), (M, 1, 1)) for p in bucket.pars)
        solvers.append((solver, x0b, pars))

    def dispatch():
        """One batch solve; returns the outs and a scalar that depends on
        every output."""
        outs = [s.solve(xb, pb) for s, xb, pb in solvers]
        total = outs[0].x.sum()
        for o in outs[1:]:
            total = total + o.x.sum()
        return outs, total

    def run_once():
        outs, total = dispatch()
        total.block_until_ready()
        return outs

    # Warm up (compile) + correctness gate.
    outs = run_once()
    ok = all(bool(np.asarray(o.converged).all()) for o in outs)
    sat = all(bool(np.asarray(o.satisfied).all()) for o in outs)
    iters = max(int(np.asarray(o.iterations).max()) for o in outs)
    # Independent f64 verification of the warmup answers (outside the
    # timed region): recomputes the TRUE f64 residual for every copy.
    rmax = 0.0
    for (solver, _xv, pb), o in zip(solvers, outs):
        system = solver.system
        r, _deg = jax.vmap(lambda x, *p: system.residual_and_flags(x, p))(
            jnp.asarray(o.x, jnp.float64), *pb)
        rmax = max(rmax, float(jnp.max(jnp.abs(r))))
    ok = ok and rmax <= 1e-8
    if not (ok and sat):
        print(json.dumps({"metric": "massive_parallel_system_solves_per_sec",
                          "value": 0.0, "unit": "solves/sec", "vs_baseline": 0.0,
                          "error": "did not converge/satisfy"}))
        return 1

    # Timed region: per-rep times, median reported. Two protocols: `sync`
    # = one sync per batch; `amortized` = CHAIN dispatches per sync, one
    # final sync on a scalar depending on every output — the steady-state
    # pipeline rate, the closest analog of the reference CLI's in-process
    # 100-resolve hot loop (ezpz-cli/src/main.rs:96-100), reported as the
    # headline. EZPZ_PROFILE_DIR captures a jax.profiler trace (the analog
    # of the reference's `just flamegraph`, justfile:35-36).
    profile_dir = os.environ.get("EZPZ_PROFILE_DIR")
    if profile_dir:
        jax.profiler.start_trace(profile_dir)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run_once()
        times.append(time.perf_counter() - t0)
    dt = sorted(times)[len(times) // 2]
    ctimes = []
    for _ in range(reps):
        t0 = time.perf_counter()
        acc = None
        for _ in range(CHAIN):
            _outs, total = dispatch()
            acc = total if acc is None else acc + total
        acc.block_until_ready()
        ctimes.append(time.perf_counter() - t0)
    cdt = sorted(ctimes)[len(ctimes) // 2]
    if profile_dir:
        jax.profiler.stop_trace()
    sync_solves_per_sec = M / dt
    solves_per_sec = CHAIN * M / cdt

    detail = {
        "system": "2400 vars / 2400 eqs x %d copies" % M,
        "dtype": precision + " (residual verified in float64, max %.1e)" % rmax,
        "residual_tolerance": 1e-8,
        "lm_iterations": iters,
        "device": {"platform": jax.devices()[0].platform,
                   "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())},
        "sketch_solves_per_sec": round(solves_per_sec * 600, 0),
        "protocol": "amortized: %d dispatches/sync (one final scalar sync "
                    "over all outputs) — steady-state pipeline rate, the "
                    "analog of the reference CLI's in-process hot loop; "
                    "sync rate below syncs once per batch" % CHAIN,
        "sync_solves_per_sec": round(sync_solves_per_sec, 1),
    }

    # Second headline: the genuinely COUPLED (non-block-diagonal) massive
    # system via the partitioned-Schur solver — the reference capability
    # the block-diagonal fixture does not exercise (newton.rs:87-102).
    if os.environ.get("BENCH_COUPLED", "1") not in ("", "0"):
        sys.path.insert(0, os.path.join(here, "benches"))
        from coupled_bench import run as coupled_run

        # Operating point: the exact banded-direct boundary at n_parts=120
        # (the chain's boundary Schur complement is block-tridiagonal,
        # bw=11, so the banded solve is exact) at copies=1024. Not yet
        # re-swept on the GPU.
        detail["coupled"] = coupled_run(
            lines=600, copies=int(os.environ.get("BENCH_COUPLED_COPIES", "1024")),
            precision="mixed", reps=3,
            n_parts=int(os.environ.get("BENCH_COUPLED_PARTS", "120")),
            boundary_solver=os.environ.get("BENCH_COUPLED_BOUNDARY", "banded"),
            # batch=1 synchronous latency rides along (~3 warm solves):
            # the interactive-use complement of the batched rate.
            latency=True)

    print(json.dumps({
        "metric": "massive_parallel_system_solves_per_sec",
        "value": round(solves_per_sec, 1),
        "unit": "solves/sec",
        "vs_baseline": round(solves_per_sec / BASELINE_SOLVES_PER_SEC, 3),
        "detail": detail,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
