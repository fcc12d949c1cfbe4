"""Repo-root pytest config: pin the CPU backend with a faked 8-device mesh
for EVERY collected file — including ``--doctest-modules`` runs over
``ezpz_jax/`` — by setting ``jax_platforms=cpu`` before any backend
initializes (tests that need a card are marked ``gpu`` and run through
``chip_smoke.py`` instead). ``tests/conftest.py`` applies the same
settings; both are idempotent."""

import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import ezpz_jax

# EZPZ_NO_CACHE=1 opts out of the persistent compilation cache: long
# fuzzing runs compile hundreds of distinct throwaway topologies, and
# jax's cache writer (zstandard serialization in put_executable_and_time)
# has segfaulted intermittently under that many-compile stress on this
# image. Normal suite runs keep the cache (it cuts wall time ~2x).
if os.environ.get("EZPZ_NO_CACHE", "") in ("", "0"):
    ezpz_jax.enable_compilation_cache()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running integration test (multi-process spawns)"
    )
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips (with a reason) where JAX "
        "finds none — decided inside the test, never at import"
    )


# Full-suite runs accumulate thousands of live compiled executables; on this
# image jaxlib's XLA:CPU AOT loader has segfaulted deterministically late in
# the run (inside compilation_cache get_executable_and_time ->
# backend.deserialize_executable) once that population is large enough.
# Dropping the in-process executable cache every N tests caps the live count;
# re-compiles after a drop are near-free disk hits on the persistent cache.
_CLEAR_EVERY = int(os.environ.get("EZPZ_CLEAR_CACHES_EVERY", "40"))
_test_counter = {"n": 0}


def pytest_runtest_teardown(item, nextitem):
    if _CLEAR_EVERY <= 0:
        return
    _test_counter["n"] += 1
    if _test_counter["n"] % _CLEAR_EVERY == 0:
        jax.clear_caches()
