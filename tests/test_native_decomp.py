"""Native C++ connected-components (fastdecomp) vs the Python union-find."""

import numpy as np
import pytest

from ezpz_jax.models.blocks import (
    _component_roots_native,
    _component_roots_python,
    connected_components,
)
from ezpz_jax.native import load_fastdecomp


def _random_deps(rng, n_cons, n_vars):
    deps = []
    for _ in range(n_cons):
        k = int(rng.integers(0, 5))
        deps.append(sorted(set(int(v) for v in rng.integers(0, n_vars, k))))
    return deps


def test_native_matches_python_partition():
    mod = load_fastdecomp()
    if mod is None:
        pytest.skip("no C++ toolchain")
    rng = np.random.default_rng(7)
    for trial in range(20):
        n_vars = int(rng.integers(1, 60))
        deps = _random_deps(rng, int(rng.integers(0, 40)), n_vars)
        vr_n, cr_n = _component_roots_native(deps, n_vars)
        vr_p, cr_p = _component_roots_python(deps, n_vars)
        # The partition must match (root labels are canonical in both).
        assert vr_n == vr_p, trial
        assert cr_n == cr_p, trial


def test_native_rejects_wrong_dtype_buffers():
    """int64 / float32 arrays must raise TypeError, never be silently
    reinterpreted as int32."""
    mod = load_fastdecomp()
    if mod is None:
        pytest.skip("no C++ toolchain")
    offsets = np.array([0, 1], np.int32)
    ids = np.array([0], np.int32)
    with pytest.raises(TypeError):
        mod.components(4, offsets.astype(np.int64), ids)
    with pytest.raises(TypeError):
        mod.components(4, offsets, ids.astype(np.int64))
    with pytest.raises(TypeError):
        mod.components(4, offsets, ids.astype(np.float32))
    with pytest.raises(TypeError):
        mod.components(4, offsets, ids.tobytes())  # raw bytes: format 'B'


def test_native_rejects_bad_ids():
    mod = load_fastdecomp()
    if mod is None:
        pytest.skip("no C++ toolchain")
    offsets = np.array([0, 1], np.int32)
    ids = np.array([99], np.int32)  # out of range for n_vars=4
    with pytest.raises(ValueError):
        mod.components(4, offsets, ids)


def test_empty_and_isolated_constraints():
    from ezpz_jax.constraints import Constraint

    # Two isolated Fixed constraints and one shared pair.
    cs = [
        Constraint.Fixed(0, 1.0),
        Constraint.Fixed(3, 2.0),
        Constraint.ScalarEqual(1, 2),
    ]
    comps = connected_components(cs, 4)
    assert len(comps) == 3
    assert [c.constraint_ids for c in comps] == [[0], [1], [2]]
    assert [c.var_ids for c in comps] == [[0], [3], [1, 2]]
