"""Test configuration: run on CPU with a virtual 8-device mesh.

``jax_platforms=cpu`` is set through ``jax.config`` before any backend
initializes, so the suite runs on the CPU even where a card is present.
"""

import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax
import pytest

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

# Persistent compilation cache: repeated suite runs skip recompiling the
# (identical) jitted solvers, cutting wall time substantially.
# EZPZ_NO_CACHE=1 opts out (see the repo-root conftest.py: jax's cache
# writer has segfaulted under long fuzzing's many-compile stress).
import ezpz_jax

if os.environ.get("EZPZ_NO_CACHE", "") in ("", "0"):
    ezpz_jax.enable_compilation_cache()


@pytest.fixture
def gpu_device():
    """The first CUDA device, or a skip. Decided here, at test time — never
    while a module is imported, so every xdist worker collects the same
    tests. The suite pins ``jax_platforms=cpu``, so tests marked ``gpu``
    skip in it; ``chip_smoke.py`` is the command that runs on the card."""
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("no CUDA device (the suite pins jax_platforms=cpu; run "
                    "chip_smoke.py on the card)")
    return devices[0]
