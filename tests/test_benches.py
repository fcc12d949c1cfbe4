"""The benchmark scripts must keep running (bitrot guards): one tiny
iteration of the criterion-style suite and of the scaling bench on the
faked CPU mesh."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, timeout=420):
    env = dict(os.environ)
    env.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable] + args, capture_output=True,
                          text=True, timeout=timeout, cwd=ROOT, env=env)


def test_solver_bench_runs():
    proc = _run(["benches/solver_bench.py", "--cpu", "--json", "--iters", "1",
                 "--only", "solve_two_rectangles"])
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [l for l in proc.stdout.splitlines() if l.startswith("{")]
    assert lines, proc.stdout
    rec = json.loads(lines[0])
    assert rec["bench"].startswith("solve_two_rectangles")
    assert rec["solves_per_sec"] > 0


def test_scaling_bench_runs():
    proc = _run(["benches/scaling_bench.py", "--sweep", "1,2", "--reps", "1",
                 "--fleet-per-device", "64", "--schur-points-per-device", "6"])
    assert proc.returncode == 0, proc.stderr[-2000:]
    rec = json.loads([l for l in proc.stdout.splitlines() if l.startswith("{")][0])
    assert rec["metric"] == "weak_scaling_efficiency"
    assert rec["devices"] == [1, 2]
    assert "2" in rec["fleet_efficiency"] and "2" in rec["schur_efficiency"]
    # Iteration-count flatness: sharding must not change LM convergence.
    iters = {d: r["iterations"] for d, r in rec["schur"].items()}
    assert len(set(iters.values())) == 1, iters


def test_coupled_bench_runs():
    proc = _run(["benches/coupled_bench.py", "--cpu", "--lines", "12",
                 "--copies", "2", "--reps", "1"])
    assert proc.returncode == 0, proc.stderr[-2000:]
    rec = json.loads([l for l in proc.stdout.splitlines() if l.startswith("{")][0])
    assert rec["metric"] == "coupled_system_solves_per_sec"
    assert rec["value"] > 0
    assert rec["detail"]["n_boundary"] > 0  # genuinely coupled
    assert rec["detail"]["final_residual_inf"] <= 1e-8


def test_midsize_bench_runs_and_routes_midsize_tier():
    """rect_chain[4] is 26 vars — past the 24-var full unroll, so the
    XLA-mixed path routes its normal-equation solves through the
    matmul-free column-sweep tier (ops/linalg.spd_solve_batched). The
    bench's own correctness gate (converged + satisfied + f64 residual)
    is the end-to-end check that the tier solves real systems."""
    proc = _run(["benches/midsize_bench.py", "--cpu", "--copies", "32",
                 "--reps", "1", "--only", "rect_chain[4]"])
    assert proc.returncode == 0, proc.stderr[-2000:]
    rec = json.loads([l for l in proc.stdout.splitlines() if l.startswith("{")][0])
    assert rec["n_vars"] == 26
    assert rec["converged"] and rec["satisfied"]
    assert rec["residual_f64_max"] <= 1e-8
