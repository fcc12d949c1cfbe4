"""CLI integration tests (mirrors ezpz-cli/src/main.rs:246-299)."""

import os
import subprocess
import sys

from .helpers import CASES_DIR

ENV = {**os.environ, "JAX_PLATFORMS_FORCE_CPU": "1"}


def _run_cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "ezpz_jax.cli", "--cpu", *args],
        capture_output=True,
        text=True,
        cwd=os.path.dirname(os.path.dirname(__file__)),
        timeout=400,
    )


def test_cli_tiny():
    res = _run_cli("-f", os.path.join(CASES_DIR, "tiny", "problem.md"))
    assert res.returncode == 0, res.stderr
    assert "Problem size: 4 rows, 4 vars" in res.stdout
    assert "Iterations needed:" in res.stdout
    assert "solves per second" in res.stdout


def test_cli_arc_radius_with_points_and_png(tmp_path):
    png = str(tmp_path / "out.png")
    res = _run_cli(
        "-f", os.path.join(CASES_DIR, "arc_radius", "problem.md"),
        "--show-points", "--image-path", png,
    )
    assert res.returncode == 0, res.stderr
    assert "Problem size: 4 rows, 8 vars" in res.stdout
    assert "Arcs:" in res.stdout
    assert os.path.exists(png) and os.path.getsize(png) > 1000


def test_cli_stdin():
    txt = open(os.path.join(CASES_DIR, "tiny", "problem.md")).read()
    res = subprocess.run(
        [sys.executable, "-m", "ezpz_jax.cli", "--cpu", "-f", "-"],
        input=txt,
        capture_output=True,
        text=True,
        cwd=os.path.dirname(os.path.dirname(__file__)),
        timeout=400,
    )
    assert res.returncode == 0, res.stderr
    assert "Problem size: 4 rows, 4 vars" in res.stdout


def test_cli_parse_error():
    res = subprocess.run(
        [sys.executable, "-m", "ezpz_jax.cli", "--cpu", "-f", "-"],
        input="# constraints\nbogus(p)\n\n# guesses\np roughly (0,0)\n",
        capture_output=True,
        text=True,
        cwd=os.path.dirname(os.path.dirname(__file__)),
        timeout=400,
    )
    assert res.returncode == 1
    assert "Error" in res.stderr
