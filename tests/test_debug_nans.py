"""EZPZ_DEBUG_NANS=1 — the sanitizer analog (SURVEY.md section 5):
JAX's NaN debugger must be armed by the env var and catch a NaN-producing
op at its source. Subprocess-level: the flag is read at import time.
"""

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import jax
jax.config.update("jax_platforms", "cpu")
import ezpz_jax  # reads EZPZ_DEBUG_NANS at import
import jax.numpy as jnp

@jax.jit
def bad(x):
    return jnp.sqrt(x)  # sqrt(-1) -> NaN

try:
    float(bad(jnp.asarray(-1.0)))
    print("NO-RAISE")
except FloatingPointError:
    print("CAUGHT-NAN")
"""


def _run(env_extra):
    env = dict(os.environ)
    env.update(env_extra)
    return subprocess.run([sys.executable, "-c", _PROBE],
                          capture_output=True, text=True, cwd=HERE, env=env,
                          timeout=240)


def test_debug_nans_armed():
    out = _run({"EZPZ_DEBUG_NANS": "1"})
    assert "CAUGHT-NAN" in out.stdout, (out.stdout, out.stderr[-1500:])


def test_debug_nans_off_by_default():
    """Off by default: NaN-on-non-SPD is the solver's own failure signal,
    so the hot path must tolerate NaNs silently."""
    out = _run({"EZPZ_DEBUG_NANS": ""})
    assert "NO-RAISE" in out.stdout, (out.stdout, out.stderr[-1500:])
