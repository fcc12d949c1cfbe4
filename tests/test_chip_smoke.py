"""chip_smoke.py on the CPU: the script refuses to run without a card (or
without the repo), and each phase function runs and checks at a tiny
size — the same code the card runs at full size."""

import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402


def _run_script(path, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, path], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _ok_line(stdout):
    return any(l.startswith("{") and '"ok"' in l for l in stdout.splitlines())


def test_exits_nonzero_without_a_card():
    proc = _run_script(os.path.join(ROOT, "chip_smoke.py"), ROOT)
    assert proc.returncode != 0
    assert not _ok_line(proc.stdout), proc.stdout
    assert "no GPU" in proc.stderr


def test_exits_nonzero_without_the_repo(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    proc = _run_script(str(tmp_path / "chip_smoke.py"), str(tmp_path))
    assert proc.returncode != 0
    assert not _ok_line(proc.stdout), proc.stdout


def test_phase_corpus_small():
    out = chip_smoke.phase_corpus(
        cases=["tiny", "perpdist", "circle_tangent"], cli_case="tiny")
    assert out["cases"] == 3 and out["max_dx"] < chip_smoke.COORD_TOL


def test_phase_corpus_fails_on_an_iteration_flip(tmp_path, monkeypatch):
    golden = json.load(open(chip_smoke.GOLDEN_ITERATIONS))
    golden["tiny"] += 1
    path = tmp_path / "golden.json"
    path.write_text(json.dumps(golden))
    monkeypatch.setattr(chip_smoke, "GOLDEN_ITERATIONS", str(path))
    with pytest.raises(chip_smoke.Mismatch, match="accept/reject flipped"):
        chip_smoke.phase_corpus(cases=["tiny"], cli_case="tiny")


def test_phase_fleet_small():
    out = chip_smoke.phase_fleet(copies=2, lanes=4, reps=1)
    assert out["sketches"] == 2 * 1800  # 600 lines -> 1,800 components
    for precision in ("f64", "mixed"):
        assert out[precision]["residual_max"] <= chip_smoke.RESIDUAL_TOL
    assert out["lane_max_dx"] <= chip_smoke.LANE_X_TOL


def test_phase_coupled_small():
    out = chip_smoke.phase_coupled(lines=24, copies=2, n_parts=4, reps=1)
    assert out["f64"]["boundary_solver"] == "banded"
    assert out["copy_dx"] <= chip_smoke.COUPLED_X_TOL


def test_phase_service_small():
    out = chip_smoke.phase_service(n_requests=8)
    assert out["max_dx"] <= chip_smoke.SERVICE_X_TOL


def test_phase_freedom_small():
    out = chip_smoke.phase_freedom(lanes=8, reps=1)
    assert out["gap_decades"] > 1.0


def test_phase_cards_on_four_virtual_devices():
    out = chip_smoke.phase_cards(4, copies_per_card=1, hub_lines=51,
                                 hub_cluster=5)
    assert out["fleet_max_dx"] <= chip_smoke.SHARD_X_TOL
    assert out["hub_dx"] <= chip_smoke.HUB_X_TOL


def test_busy_and_window_unions_overlapping_spans():
    busy, window = chip_smoke.busy_and_window(
        [(10, 20), (0, 5), (15, 30), (40, 50)])
    assert (busy, window) == (5 + 20 + 10, 50)


def test_trace_summary_of_a_cpu_trace_is_none(tmp_path):
    import jax
    import jax.numpy as jnp

    jax.profiler.start_trace(str(tmp_path))
    jnp.ones(4).sum().block_until_ready()
    jax.profiler.stop_trace()
    assert chip_smoke.trace_summary(str(tmp_path)) is None


@pytest.mark.gpu
def test_phase_fleet_on_the_card(gpu_device):
    import jax

    with jax.default_device(gpu_device):
        out = chip_smoke.phase_fleet(copies=64, lanes=8, reps=1)
    assert out["f64"]["residual_max"] <= chip_smoke.RESIDUAL_TOL
