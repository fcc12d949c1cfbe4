# Dev recipes, mirroring the reference's justfile (`/root/reference/justfile`).
# `just` is optional: every recipe is a one-liner you can paste into a shell.

# Run the full test suite on the (faked 8-device) CPU backend.
test:
    python -m pytest tests/ -q

# Fast signal: stop at the first failure.
test-fast:
    python -m pytest tests/ -x -q

# Static checks: byte-compile everything and verify the test collection.
lint:
    python -m compileall -q ezpz_jax tests benches tools bench.py __graft_entry__.py
    python -m pytest tests/ -q --collect-only > /dev/null

# Runnable-docs check (the analog of `cargo test --doc`). The repo-root
# conftest.py pins the CPU backend for these.
doctest:
    python -m pytest --doctest-modules \
        ezpz_jax/config.py ezpz_jax/utils/ids.py ezpz_jax/api.py \
        ezpz_jax/batch.py ezpz_jax/constraints.py ezpz_jax/dof.py \
        ezpz_jax/serve.py ezpz_jax/textual/problem.py \
        ezpz_jax/parallel/fleet.py ezpz_jax/parallel/schur.py \
        ezpz_jax/parallel/block_schur.py -q

# Headline benchmark (one JSON line; runs on whatever device JAX picks).
bench:
    python bench.py

# The criterion-style per-case suite (solver_bench.rs equivalent).
bench-suite *ARGS:
    python benches/solver_bench.py {{ARGS}}

# Scaling-efficiency benchmark on a faked N-device CPU mesh.
bench-scaling N="8":
    XLA_FLAGS=--xla_force_host_platform_device_count={{N}} JAX_PLATFORMS=cpu \
        python benches/scaling_bench.py --devices {{N}}

# Regenerate the massive_parallel_system fixture at N vars (4 per line).
regen-massive-test N="2000":
    python tools/gen_massive.py $(( {{N}} / 4 )) > tests/cases/massive_parallel_system/problem.md

# Long-running randomized fuzzing (hypothesis, ~2000 examples total),
# CHUNKED across fresh processes: jaxlib's XLA:CPU compiler on this image
# segfaults sporadically after many hundreds of distinct compilations in
# one process (its AOT loader warns about mismatched machine features —
# "could lead to SIGILL"; observed in both the cache writer and
# backend_compile_and_load, with and without the persistent cache).
# Chunking bounds per-process compile count; an infra segfault (exit 139)
# skips to the next chunk, while a REAL fuzz failure (pytest exit 1)
# stops the recipe. Hypothesis draws fresh examples per invocation.
fuzz:
    #!/usr/bin/env bash
    set -u
    for i in $(seq 1 20); do
        EZPZ_FUZZ_EXAMPLES=100 EZPZ_NO_CACHE=1 \
            python -m pytest tests/test_fuzz.py -q
        rc=$?
        if [ $rc -eq 1 ]; then echo "fuzz FAILURE in chunk $i"; exit 1; fi
        if [ $rc -ne 0 ]; then echo "chunk $i: infra crash rc=$rc (jaxlib XLA:CPU, skipping)"; fi
    done
    echo "fuzz: 20 chunks complete"

# Line coverage over ezpz_jax/ (the llvm-cov/codecov analog) — homegrown
# sys.monitoring-based tool; no coverage package ships in this image.
coverage *ARGS="tests/ -q":
    python tools/coverage.py --json coverage.json {{ARGS}}

# Mutation testing (the `just mutants` analog, reference justfile:107-110).
# Self-contained AST mutator — no external tool. Targeted selections keep
# each mutant's run fast; see tools/mutate.py for usage.
#
# This recipe is the quick SAMPLED pass. The precision-critical modules
# were run IN FULL in round 3 — raw kill rates before survivor-driven
# tests: parallel/block_schur.py 54/64 (84%, second run),
# models/compiled.py 8/22 (36%), textual/executor.py 41/47 (87%),
# solver.py 41/64 across two segments (60/60 non-equivalent after the new
# tests), ops/kernels.py 22/32 sampled (31/31 non-equivalent after);
# after the new tests every NON-EQUIVALENT mutant is killed
# (hand-confirmed per survivor). Round 5 mutated the banded tier in full
# with `--lines`: ops/banded.py plan/solve 10/10. Protocol, killer tests,
# and the equivalent-survivor adjudication: docs/MUTATION.md. Full runs
# mutate files in place: run them in a disposable copy of the repo,
# never the live tree (see mutants-full).
mutants:
    python tools/mutate.py ezpz_jax/utils/warnings.py -- tests/test_warnings_lint.py -q
    python tools/mutate.py ezpz_jax/solver.py --sample 40 -- \
        tests/test_solver_edges.py tests/test_cg.py tests/test_mixed_precision.py \
        tests/test_golden_fixtures.py tests/test_api.py -q
    python tools/mutate.py ezpz_jax/ops/kernels.py --sample 40 -- \
        tests/test_properties.py tests/test_properties_families.py \
        tests/test_golden_fixtures.py -q

# Full (unsampled) mutation runs over the precision-critical modules, in a
# throwaway copy so in-place mutation can never corrupt the live tree.
# Takes hours on one core; see docs/MUTATION.md for the round-3 results.
mutants-full:
    rm -rf /tmp/ezpz_mutfull && mkdir -p /tmp/ezpz_mutfull
    tar cf - --exclude .git --exclude __pycache__ --exclude .jax_cache . | tar xf - -C /tmp/ezpz_mutfull
    cd /tmp/ezpz_mutfull && python tools/mutate.py ezpz_jax/parallel/block_schur.py -- \
        tests/test_block_schur.py -x -q
    cd /tmp/ezpz_mutfull && python tools/mutate.py ezpz_jax/models/compiled.py -- \
        tests/test_oracle_scipy.py tests/test_golden_fixtures.py -x -q
    cd /tmp/ezpz_mutfull && python tools/mutate.py ezpz_jax/textual/executor.py -- \
        tests/test_native_parser.py tests/test_golden_fixtures.py -x -q

# Quick fuzz sanity (the CI `fuzz-check` analog).
fuzz-check:
    python -m pytest tests/test_fuzz.py -q

# Regenerate the residual-field visual-regression baselines.
regen-viz-baselines:
    TWENTY_TWENTY=overwrite python -m pytest tests/test_residual_viz.py -q

# Capture a jax.profiler trace of the headline bench into ./profile/.
profile:
    EZPZ_PROFILE_DIR=profile python bench.py

# Build the native C++ extensions (fast parser + decomposition) in-place.
native:
    python -c "from ezpz_jax.native import build; print(build('fastparse', verbose=True)); print(build('fastdecomp', verbose=True))"
