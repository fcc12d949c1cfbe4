"""Every corpus fixture through the XLA mixed-precision BatchSolver: on
every lane where the f64 path reaches the 1e-8 residual, the mixed path
converges too and its answer meets 1e-8 in a true f64 residual pass."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ezpz_jax  # noqa: F401
from ezpz_jax.batch import BatchSolver
from ezpz_jax.config import Config

from .corpus import CASES, fixture_system, three_lanes


def _f64_residual(system, xs):
    r, _deg = jax.vmap(system.residual_and_flags)(jnp.asarray(xs, jnp.float64))
    return np.max(np.abs(np.asarray(r)), axis=1, initial=0.0)


@pytest.mark.parametrize("case", CASES)
def test_mixed_batch_meets_f64_tolerance(case):
    system, x0 = fixture_system(case)
    cfg = Config()
    x0b = jnp.asarray(three_lanes(x0))
    f64 = BatchSolver(system, cfg).solve(x0b)
    mixed = BatchSolver(system, cfg, precision="mixed").solve(x0b)
    reached = (np.asarray(f64.converged)
               & (_f64_residual(system, f64.x) <= cfg.residual_tolerance))
    r_mixed = _f64_residual(system, mixed.x)
    assert np.asarray(mixed.converged)[reached].all()
    assert (r_mixed[reached] <= cfg.residual_tolerance).all(), r_mixed
