#!/usr/bin/env python3
"""Smoke test of the solver's main path on an NVIDIA card, at real sizes.

    python chip_smoke.py              # one card: phases 1-5 below
    python chip_smoke.py --quick      # compile + check each phase once, print
                                      # the fleet executables' memory_analysis()
    python chip_smoke.py --trace DIR  # also trace the fleet phase into DIR and
                                      # print launches per LM iteration and the
                                      # device idle share
    python chip_smoke.py --cards 4    # four cards: the sharded paths only

Everything runs in ONE process (a second JAX process could not get the
card's memory). Phases, each compared with a reference and raising on a
mismatch:

1. corpus  — every textual fixture under tests/cases through the public
   API on the card, against the same solve on the CPU device (coordinates
   within tests/helpers.EPSILON, underconstrained ids and unsatisfied
   constraints equal) and tests/golden_iterations.json (exactly); plus the
   CLI on massive_parallel_system.
2. fleet   — massive_parallel_system as bench.py builds it (build_buckets:
   its 600 lines split into 1,800 components in two topology buckets;
   8192 copies = 14,745,600 sketches) through BatchSolver in f64 and in
   mixed; every copy converged and satisfied, f64 residual of
   every copy <= 1e-8, and 64 sampled lanes re-solved by solver.solve_lm on
   the CPU device: x within 1e-10, iteration counts equal.
3. coupled — the 2,400-variable coupled chain as bench.py runs it
   (benches/coupled_bench.run: 1,024 copies, n_parts=120, banded boundary)
   in f64 and mixed with batch-1 latency; one copy against a monolithic
   solve_lm on the CPU device.
4. service — SolverService answering 64 concurrent requests from 4 corpus
   topologies; every answer equal to the public API's.
5. freedom — BatchSolver.solve_analysis (batched SVD) on the perpdist
   fixture; underconstrained ids equal the golden ones for every lane.

The last line of standard output is the JSON object
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Where JAX finds no GPU the script exits non-zero and prints no such line.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CASES = os.path.join(ROOT, "tests", "cases")
GOLDEN_ITERATIONS = os.path.join(ROOT, "tests", "golden_iterations.json")

# Tolerances, each with its reason.
# Golden coordinates are pinned at the reference's 1e-4 (tests/helpers.py).
COORD_TOL = 1e-4
# The solve's own residual target (Config.residual_tolerance).
RESIDUAL_TOL = 1e-8
# Card against CPU on one 4-variable f64 sketch: same LM steps, only the
# factorization's and XLA's rounding differ (cuSOLVER vs LAPACK/Eigen).
LANE_X_TOL = 1e-10
# A coupled copy against the monolithic CPU solve: both converge to the
# 1e-8 residual of a well-determined system, so x agrees to that order.
COUPLED_X_TOL = 1e-8
# SolverService (vmapped BatchSolver) against the public API (one solve):
# both f64 with the same LM semantics; only summation order differs.
SERVICE_X_TOL = 1e-9
# A FleetSolver shard against a one-card BatchSolver on the same shard:
# the same executable body, partitioned along the batch axis only.
SHARD_X_TOL = 1e-12
# The hub system on four cards against one card: the boundary CG's psums
# reduce in another order, and both stop at the 1e-8 residual.
HUB_X_TOL = 1e-8
FREEDOM_CASE, FREEDOM_GOLDEN = "perpdist", [4, 5]  # test_golden_fixtures
SERVICE_CASES = ("tiny", "square", "two_rectangles", "circle")


class Mismatch(AssertionError):
    pass


def check(cond, what):
    if not cond:
        raise Mismatch(what)


def log(*parts):
    print(*parts, flush=True)


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def _arrays(out):
    """The arrays inside ``out``, looking through dataclass results (which
    are not pytrees, so block_until_ready would not wait on them)."""
    if dataclasses.is_dataclass(out):
        return [_arrays(getattr(out, f.name)) for f in dataclasses.fields(out)]
    if isinstance(out, (list, tuple)):
        return [_arrays(o) for o in out]
    return out


def _timed(fn, reps):
    """(out, first_call_s, warm_s): the first call compiles; warm is the
    median of ``reps`` further calls, each ended by block_until_ready."""
    import jax

    t0 = time.perf_counter()
    out = fn()
    jax.block_until_ready(_arrays(out))
    first = time.perf_counter() - t0
    warm = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(_arrays(fn()))
        warm.append(time.perf_counter() - t0)
    return out, first, (_median(warm) if warm else first)


def _peak_bytes(device=None):
    import jax

    stats = (device or jax.devices()[0]).memory_stats()
    return None if not stats else stats.get("peak_bytes_in_use")


def _read_case(case):
    with open(os.path.join(CASES, case, "problem.md")) as fh:
        return fh.read()


def _fixture(case):
    """(constraints, x0) of a textual fixture."""
    import numpy as np

    from ezpz_jax.textual import Problem

    cs = Problem.from_str(_read_case(case)).to_constraint_system()
    x0 = np.zeros(len(cs.initial_guesses))
    for vid, val in cs.initial_guesses:
        x0[vid] = val
    return [r.constraint for r in cs.constraints], x0


def _solve_text(txt, analysis=True):
    from ezpz_jax.config import Config
    from ezpz_jax.textual import Problem

    system = Problem.from_str(txt).to_constraint_system()
    if analysis:
        return system.solve_with_config_analysis(Config())
    return system.solve_with_config(Config())


def card_line():
    """The card's name and power limit as nvidia-smi reports them (a
    subprocess that does not touch JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


# -- phase 1 -----------------------------------------------------------------


def phase_corpus(cases=None, cli_case="massive_parallel_system"):
    import jax
    import numpy as np

    from ezpz_jax import cli

    with open(GOLDEN_ITERATIONS) as fh:
        golden = json.load(fh)
    cases = sorted(golden) if cases is None else list(cases)
    cpu = jax.devices("cpu")[0]
    t0 = time.perf_counter()
    worst = 0.0
    for case in cases:
        txt = _read_case(case)
        got = _solve_text(txt)
        with jax.default_device(cpu):
            ref = _solve_text(txt)
        g, r = got.outcome, ref.outcome
        check(g.iterations == golden[case],
              f"{case}: {g.iterations} LM iterations on the card, golden "
              f"{golden[case]} (CPU device: {r.iterations}) — an "
              f"accept/reject flipped")
        check(g.converged == r.converged, f"{case}: converged differs")
        check(list(g.unsatisfied) == list(r.unsatisfied),
              f"{case}: unsatisfied {g.unsatisfied} vs {r.unsatisfied}")
        check(got.analysis.underconstrained() == ref.analysis.underconstrained(),
              f"{case}: underconstrained {got.analysis.underconstrained()} "
              f"vs {ref.analysis.underconstrained()}")
        dx = float(np.max(np.abs(np.asarray(g.final_values)
                                 - np.asarray(r.final_values)), initial=0.0))
        check(dx < COORD_TOL, f"{case}: coordinates differ by {dx:.3e}")
        worst = max(worst, dx)
    corpus_s = time.perf_counter() - t0

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["-f", os.path.join(CASES, cli_case, "problem.md")])
    cli_s = time.perf_counter() - t0
    text = buf.getvalue()
    check(rc == 0, f"cli on {cli_case} returned {rc}: {text[-500:]}")
    want = f"Iterations needed: {golden[cli_case]}"
    check(want in text, f"cli on {cli_case}: no '{want}' in {text[-500:]}")
    rate = [ln for ln in text.splitlines() if "solves per second" in ln]
    log(f"[corpus] {len(cases)} fixtures through the public API, card vs CPU "
        f"device: iterations == golden, underconstrained/unsatisfied equal, "
        f"max |dx| {worst:.3e} (< {COORD_TOL}); {corpus_s:.2f} s incl. "
        f"compiles; cli -f {cli_case}: rc 0, '{want}', "
        f"{rate[0].strip() if rate else '?'} ({cli_s:.2f} s); "
        f"peak bytes {_peak_bytes()}")
    return {"cases": len(cases), "max_dx": worst}


# -- phase 2 -----------------------------------------------------------------


def _massive_buckets():
    from ezpz_jax.models.blocks import build_buckets

    constraints, x0 = _fixture("massive_parallel_system")
    return build_buckets(constraints, len(x0)), x0


def phase_fleet(copies=8192, lanes=64, reps=3, trace_dir=None, quick=False):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ezpz_jax.batch import BatchSolver
    from ezpz_jax.config import Config
    from ezpz_jax.solver import solve_lm

    buckets, x0 = _massive_buckets()
    cfg = Config()
    inputs = []
    for b in buckets:
        xb = jnp.tile(jnp.asarray(x0[b.var_index]), (copies, 1))
        pb = tuple(jnp.tile(jnp.asarray(p), (copies, 1, 1)) for p in b.pars)
        inputs.append((xb, pb))
    n_sketches = sum(int(xb.shape[0]) for xb, _ in inputs)
    result = {"copies": copies, "sketches": n_sketches}
    f64_out = None
    for precision in ("f64", "mixed"):
        solvers = [BatchSolver(b.system, cfg, batch_params=True,
                               precision=precision) for b in buckets]

        def run(solvers=solvers):
            return [s.solve(xb, pb) for s, (xb, pb) in zip(solvers, inputs)]

        outs, first, warm = _timed(run, 1 if quick else reps)
        if quick:
            for s, (xb, pb) in zip(solvers, inputs):
                args = (xb, pb, cfg.residual_tolerance, cfg.step_tolerance,
                        cfg.initial_lambda)
                ma = s._run.lower(*args).compile().memory_analysis()
                log(f"[fleet] {precision} memory_analysis: {ma}")
        rmax, iters = 0.0, 0
        for b, o, (_xb, pb) in zip(buckets, outs, inputs):
            check(bool(np.asarray(o.converged).all()),
                  f"fleet {precision}: a copy did not converge")
            check(bool(np.asarray(o.satisfied).all()),
                  f"fleet {precision}: a constraint is unsatisfied")
            r, _deg = jax.vmap(
                lambda x, *p, s=b.system: s.residual_and_flags(x, p))(
                    jnp.asarray(o.x, jnp.float64), *pb)
            rmax = max(rmax, float(jnp.max(jnp.abs(r))))
            iters = max(iters, int(np.asarray(o.iterations).max()))
        check(rmax <= RESIDUAL_TOL,
              f"fleet {precision}: f64 residual {rmax:.3e} > {RESIDUAL_TOL}")
        if precision == "f64":
            f64_out = outs
        result[precision] = {"first_s": first, "warm_s": warm,
                             "residual_max": rmax, "lm_iterations": iters}
        log(f"[fleet] {precision}: {copies} copies = {n_sketches} sketches, "
            f"all converged+satisfied, f64 residual max {rmax:.3e}, "
            f"max LM iterations {iters}; first call {first:.3f} s, warm "
            f"{warm:.6f} s/batch = {copies / warm:.1f} systems/s = "
            f"{n_sketches / warm:.1f} sketches/s; peak bytes {_peak_bytes()}")
        if trace_dir:
            result[precision]["trace"] = _trace_fleet(
                run, os.path.join(trace_dir, precision), iters)

    # 64 sampled lanes of the f64 fleet against the plain reference on the
    # CPU device.
    cpu = jax.devices("cpu")[0]
    rng = np.random.default_rng(0)
    worst = 0.0
    for b, o, (xb, pb) in zip(buckets, f64_out, inputs):
        idx = rng.choice(int(xb.shape[0]), size=min(lanes, int(xb.shape[0])),
                         replace=False)
        xs, its = np.asarray(o.x)[idx], np.asarray(o.iterations)[idx]
        x0s = np.asarray(xb)[idx]
        ps = [np.asarray(p)[idx] for p in pb]
        with jax.default_device(cpu):
            one = jax.jit(lambda x, p, s=b.system: solve_lm(
                s, x, cfg.max_iterations, cfg.residual_tolerance,
                cfg.step_tolerance, cfg.initial_lambda, pars=p))
            for k in range(len(idx)):
                ref = one(x0s[k], tuple(p[k] for p in ps))
                dx = float(np.max(np.abs(np.asarray(ref.x) - xs[k])))
                check(int(ref.iterations) == int(its[k]),
                      f"fleet lane {idx[k]}: {int(its[k])} iterations on the "
                      f"card, {int(ref.iterations)} on the CPU device")
                check(dx <= LANE_X_TOL,
                      f"fleet lane {idx[k]}: |dx| {dx:.3e} > {LANE_X_TOL}")
                worst = max(worst, dx)
    log(f"[fleet] {lanes} sampled f64 lanes vs solve_lm on the CPU device: "
        f"iterations equal, max |dx| {worst:.3e} (<= {LANE_X_TOL})")
    result["lane_max_dx"] = worst
    return result


def _trace_fleet(run, trace_dir, lm_iterations, batches=3):
    import jax

    jax.block_until_ready(_arrays(run()))
    jax.profiler.start_trace(trace_dir)
    for _ in range(batches):
        jax.block_until_ready(_arrays(run()))
    jax.profiler.stop_trace()
    summary = trace_summary(trace_dir)
    if summary is None:
        log(f"[fleet] trace {trace_dir}: no GPU device plane found")
        return None
    summary["kernels_per_batch"] = summary["kernels"] / batches
    # The vmapped while_loop runs max-iterations trips per batch.
    summary["kernels_per_lm_iteration"] = (
        summary["kernels"] / (batches * max(lm_iterations, 1)))
    log(f"[fleet] trace {os.path.basename(trace_dir)}: {summary}")
    return summary


def busy_and_window(spans):
    """(busy, window) of (start, end) intervals: busy is the length of
    their union, window runs from the first start to the last end."""
    spans = sorted(spans)
    busy, cur_s, cur_e = 0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return busy, spans[-1][1] - spans[0][0]


def trace_summary(trace_dir):
    """Kernel count and device idle share from the newest profiler trace
    under ``trace_dir``: kernels are the events on the first GPU plane's
    stream lines; busy time is the union of their intervals; the window
    runs from the first kernel's start to the last kernel's end. Returns
    None when the trace holds no GPU plane (a CPU run)."""
    import glob

    from jax.profiler import ProfileData

    paths = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                             recursive=True), key=os.path.getmtime)
    if not paths:
        return None
    data = ProfileData.from_file(paths[-1])
    planes = [p for p in data.planes if p.name.startswith("/device:GPU")]
    if not planes:
        return None
    plane = sorted(planes, key=lambda p: p.name)[0]
    lines = {ln.name: list(ln.events) for ln in plane.lines}
    streams = [n for n in lines if n.startswith("Stream")]
    derived = ("XLA Modules", "XLA Ops", "Steps", "Source", "TF Ops")
    names = streams or [n for n in lines if n not in derived]
    spans = [(e.start_ns, e.start_ns + e.duration_ns)
             for n in names for e in lines[n]]
    if not spans:
        return None
    busy, window = busy_and_window(spans)
    return {"plane": plane.name, "lines": {n: len(v) for n, v in lines.items()},
            "kernels": len(spans), "window_ms": window / 1e6,
            "busy_ms": busy / 1e6,
            "idle_share": 1.0 - busy / window if window else 0.0}


# -- phase 3 -----------------------------------------------------------------


def phase_coupled(lines=600, copies=1024, n_parts=120, reps=3):
    import jax
    import numpy as np

    sys.path.insert(0, os.path.join(ROOT, "benches"))
    import coupled_bench

    from ezpz_jax.config import Config
    from ezpz_jax.models.compiled import compile_system
    from ezpz_jax.parallel import BlockSchurSolver
    from ezpz_jax.solver import solve_lm

    result = {}
    for precision in ("f64", "mixed"):
        t0 = time.perf_counter()
        out = coupled_bench.run(lines=lines, copies=copies, precision=precision,
                                reps=reps, n_parts=n_parts,
                                boundary_solver="banded", latency=True)
        total = time.perf_counter() - t0
        check("error" not in out, f"coupled {precision}: {out}")
        d = out["detail"]
        check(d["final_residual_inf"] <= RESIDUAL_TOL,
              f"coupled {precision}: residual {d['final_residual_inf']:.3e}")
        result[precision] = out
        log(f"[coupled] {precision}: {d['system']}, n_parts {d['n_parts']}, "
            f"n_boundary {d['n_boundary']}, boundary {out['boundary_solver']}"
            f", residual {d['final_residual_inf']:.3e}, LM iterations "
            f"{d['lm_iterations']}; {d['ms_per_batch']} ms/batch sync, "
            f"{d['amortized_ms_per_batch']} ms/batch amortized = "
            f"{out['value']} systems/s; batch-1 latency "
            f"{out['batch1_latency_us']} us sync, "
            f"{out['batch1_latency_pipelined_us']} us pipelined; phase "
            f"{total:.1f} s incl. compiles; peak bytes {_peak_bytes()}")

    constraints, x0 = coupled_bench.build_problem(lines)
    n = len(x0)
    cfg = Config()
    one = BlockSchurSolver(constraints, n, precision="f64", n_parts=n_parts,
                           boundary_solver="banded").solve(x0)
    check(one["converged"], "coupled single copy did not converge")
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        system = compile_system(constraints, n)
        ref = solve_lm(system, np.asarray(x0), cfg.max_iterations,
                       cfg.residual_tolerance, cfg.step_tolerance,
                       cfg.initial_lambda)
        r_card = float(np.max(np.abs(np.asarray(
            system.residual_and_flags(np.asarray(one["x"]))[0]))))
    check(bool(ref.converged), "monolithic CPU reference did not converge")
    dx = float(np.max(np.abs(np.asarray(ref.x) - one["x"])))
    check(r_card <= RESIDUAL_TOL, f"coupled copy residual {r_card:.3e}")
    check(dx <= COUPLED_X_TOL, f"coupled copy |dx| {dx:.3e} > {COUPLED_X_TOL}")
    log(f"[coupled] one f64 copy vs monolithic solve_lm on the CPU device: "
        f"residual {r_card:.3e} (<= {RESIDUAL_TOL}), max |dx| {dx:.3e} "
        f"(<= {COUPLED_X_TOL}), iterations {one['iterations']} vs "
        f"{int(ref.iterations)}")
    result["copy_dx"] = dx
    return result


# -- phase 4 -----------------------------------------------------------------


def phase_service(n_requests=64, cases=SERVICE_CASES):
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from ezpz_jax.serve import SolverService

    texts = {c: _read_case(c) for c in cases}
    order = [cases[i % len(cases)] for i in range(n_requests)]
    refs = {c: _solve_text(t, analysis=False) for c, t in texts.items()}
    svc = SolverService(batch_window_ms=20.0)
    try:
        svc.solve_text(texts[cases[0]])  # the first request compiles
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=n_requests) as ex:
            answers = list(ex.map(lambda c: svc.solve_text(texts[c]), order))
        wall = time.perf_counter() - t0
        stats = dict(svc.stats)
    finally:
        svc.shutdown()
    worst = 0.0
    for case, ans in zip(order, answers):
        ref = refs[case]
        check(ans["converged"] == ref.converged, f"service {case}: converged")
        check(ans["iterations"] == ref.iterations,
              f"service {case}: {ans['iterations']} vs {ref.iterations} "
              f"iterations")
        check(list(ans["unsatisfied"]) == list(ref.unsatisfied),
              f"service {case}: unsatisfied differs")
        for label, p in ref.points.items():
            d = float(np.max(np.abs(np.asarray(ans["points"][label])
                                    - np.asarray([p.x, p.y]))))
            check(d <= SERVICE_X_TOL, f"service {case}.{label}: |dx| {d:.3e}")
            worst = max(worst, d)
        for label, c in ref.circles.items():
            got = ans["circles"][label]
            d = max(abs(got["radius"] - c.radius),
                    abs(got["center"][0] - c.center.x),
                    abs(got["center"][1] - c.center.y))
            check(d <= SERVICE_X_TOL, f"service {case}.{label}: |dx| {d:.3e}")
            worst = max(worst, d)
    log(f"[service] {n_requests} concurrent requests over {len(cases)} "
        f"topologies ({', '.join(cases)}): all equal to the public API "
        f"(iterations, unsatisfied, max |dx| {worst:.3e} <= {SERVICE_X_TOL}); "
        f"{wall:.3f} s wall after warm-up, stats {stats}; "
        f"peak bytes {_peak_bytes()}")
    return {"wall_s": wall, "max_dx": worst}


# -- phase 5 -----------------------------------------------------------------


def phase_freedom(lanes=4096, reps=3):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ezpz_jax.batch import BatchSolver
    from ezpz_jax.config import Config
    from ezpz_jax.dof import TOLERANCE_BASE
    from ezpz_jax.models.compiled import compile_system

    constraints, x0 = _fixture(FREEDOM_CASE)
    system = compile_system(constraints, len(x0))
    solver = BatchSolver(system, Config())
    rng = np.random.default_rng(1)
    x0b = np.tile(x0, (lanes, 1)) + rng.normal(0.0, 1e-6, (lanes, len(x0)))
    x0b[0] = x0
    (res, analyses), first, warm = _timed(
        lambda: solver.solve_analysis(jnp.asarray(x0b)), reps)
    for i, a in enumerate(analyses):
        check(a.underconstrained() == FREEDOM_GOLDEN,
              f"freedom lane {i}: {a.underconstrained()} vs {FREEDOM_GOLDEN}")
    check(bool(np.asarray(res.converged).all()), "freedom: a lane diverged")
    # Distance of the singular values from the rank cut, in decades: a
    # small gap means the card's SVD could put one on the other side.
    s = np.asarray(jax.jit(jax.vmap(
        lambda x: jnp.linalg.svd(system.jacobian_dense(x),
                                 compute_uv=False)))(res.x))
    tol = TOLERANCE_BASE * s[:, :1]
    above = np.where(s > tol, s / tol, np.inf).min()
    below = np.where((s <= tol) & (s > 0), tol / np.maximum(s, 1e-300),
                     np.inf).min()
    gap = float(np.log10(min(above, below)))
    log(f"[freedom] {FREEDOM_CASE} x {lanes} lanes, batched SVD on the "
        f"device: underconstrained == {FREEDOM_GOLDEN} on every lane; "
        f"smallest singular-value gap to the rank cut {gap:.2f} decades; "
        f"first call {first:.3f} s, warm {warm:.6f} s; "
        f"peak bytes {_peak_bytes()}")
    return {"gap_decades": gap, "warm_s": warm}


# -- --cards N ---------------------------------------------------------------


def phase_cards(n_cards=4, copies_per_card=8192, hub_lines=250001,
                hub_cluster=10):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    from ezpz_jax.batch import BatchSolver
    from ezpz_jax.config import Config
    from ezpz_jax.parallel import FleetSolver, ShardedBlockSchurSolver

    devices = jax.devices()[:n_cards]
    check(len(devices) == n_cards, f"need {n_cards} devices, have "
          f"{len(jax.devices())}")
    cfg = Config()

    # Fleet: data-parallel over the cards, each shard against a one-card
    # BatchSolver on the same shard.
    buckets, x0 = _massive_buckets()
    mesh = Mesh(np.array(devices), ("batch",))
    worst = 0.0
    for b in buckets:
        copies = n_cards * copies_per_card
        xb = np.tile(x0[b.var_index], (copies, 1))
        pb = tuple(np.tile(p, (copies, 1, 1)) for p in b.pars)
        fleet = FleetSolver(b.system, mesh=mesh, config=cfg,
                            batch_params=True)
        out, first, warm = _timed(lambda: fleet.solve(xb, pb), 1)
        check(bool(np.asarray(out.converged).all()), "sharded fleet: diverged")
        xs, its = np.asarray(out.x), np.asarray(out.iterations)
        local = BatchSolver(b.system, cfg, batch_params=True)
        B = xb.shape[0]
        per = B // n_cards
        for k in range(n_cards):
            sl = slice(k * per, (k + 1) * per)
            with jax.default_device(devices[0]):
                ref = local.solve(jnp.asarray(xb[sl]),
                                  tuple(jnp.asarray(p[sl]) for p in pb))
            dx = float(np.max(np.abs(np.asarray(ref.x) - xs[sl])))
            check(np.array_equal(np.asarray(ref.iterations), its[sl]),
                  f"sharded fleet shard {k}: iterations differ")
            check(dx <= SHARD_X_TOL, f"sharded fleet shard {k}: |dx| {dx:.3e}")
            worst = max(worst, dx)
        log(f"[cards] FleetSolver over {n_cards} devices, {copies} copies = "
            f"{B} sketches: every shard equal to a one-device BatchSolver "
            f"(iterations equal, max |dx| {worst:.3e} <= {SHARD_X_TOL}); "
            f"first call {first:.3f} s, warm {warm:.6f} s/batch")

    # One giant hub-coupled system split across the cards, against the
    # same solve on a one-card mesh. In f64: the mixed path's f32 boundary
    # CG is an inexact Newton step whose iterates follow the psums'
    # reduction order, so its LM iteration count can differ by one
    # between meshes.
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from gen_massive import generate_coupled_hub

    from ezpz_jax.textual import Problem

    t0 = time.perf_counter()
    cs = Problem.from_str(generate_coupled_hub(hub_lines, hub_cluster)
                          ).to_constraint_system()
    constraints = [r.constraint for r in cs.constraints]
    x0 = np.zeros(len(cs.initial_guesses))
    for vid, val in cs.initial_guesses:
        x0[vid] = val
    line_of = np.arange(len(x0)) // 4
    part_of_var = np.where(line_of == 0, 0, 1 + (line_of - 1) // hub_cluster)
    parse_s = time.perf_counter() - t0
    outs = {}
    for d in (n_cards, 1):
        t0 = time.perf_counter()
        solver = ShardedBlockSchurSolver(
            constraints, len(x0), part_of_var=part_of_var,
            mesh=Mesh(np.array(devices[:d]), ("d",)), config=cfg,
            precision="f64", boundary_solver="cg")
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = solver.solve(x0)
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = solver.solve(x0)
        warm = time.perf_counter() - t0
        check(out["converged"], f"hub on {d} devices did not converge")
        check(out["residual_inf"] <= RESIDUAL_TOL,
              f"hub on {d} devices: residual {out['residual_inf']:.3e}")
        check(bool(np.asarray(out["satisfied"]).all()),
              f"hub on {d} devices: unsatisfied constraints")
        outs[d] = out
        log(f"[cards] ShardedBlockSchurSolver hub {len(x0)} vars on {d} "
            f"device(s): {out['n_parts']} parts, boundary {out['n_boundary']}"
            f", residual {out['residual_inf']:.3e}, LM iterations "
            f"{out['iterations']}; build {build_s:.1f} s, first solve "
            f"{first:.1f} s, warm solve {warm:.3f} s (parse {parse_s:.1f} s)")
    a, b = outs[n_cards], outs[1]
    check(a["iterations"] == b["iterations"],
          f"hub: {a['iterations']} iterations on {n_cards} devices, "
          f"{b['iterations']} on one")
    dx = float(np.max(np.abs(a["x"] - b["x"])))
    check(dx <= HUB_X_TOL, f"hub: |dx| {dx:.3e} > {HUB_X_TOL}")
    log(f"[cards] hub on {n_cards} devices vs one: iterations equal, max "
        f"|dx| {dx:.3e} (<= {HUB_X_TOL})")
    for dev in devices:
        log(f"[cards] {dev}: memory_stats {dev.memory_stats()}")
    return {"fleet_max_dx": worst, "hub_dx": dx}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4))
    ap.add_argument("--quick", action="store_true",
                    help="compile and check each phase once, print the "
                         "fleet executables' memory_analysis()")
    ap.add_argument("--trace", metavar="DIR", default=None,
                    help="trace the fleet phase into DIR")
    args = ap.parse_args(argv)

    import jax

    import ezpz_jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (devices: {jax.devices()})",
              file=sys.stderr)
        return 2
    log(card_line())
    log(f"jax {jax.__version__}, {len(jax.devices())} x {dev.device_kind}, "
        f"compile cache {ezpz_jax.enable_compilation_cache()}")
    reps = 1 if args.quick else 3
    t0 = time.perf_counter()
    if args.cards == 4:
        phase_cards(4)
    else:
        phase_corpus()
        phase_fleet(reps=reps, trace_dir=args.trace, quick=args.quick)
        phase_coupled(reps=reps)
        phase_service()
        phase_freedom(reps=reps)
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
