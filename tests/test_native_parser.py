"""Native (C++) parser parity: must produce exactly the same Problem as the
pure-Python parser on the entire fixture corpus and reject the same errors."""

import glob
import os

import pytest

from ezpz_jax.native import load_fastparse
from ezpz_jax.textual.parser import ParseError, _parse_problem_py, _problem_from_native

from .helpers import CASES_DIR

fastparse = load_fastparse()

pytestmark = pytest.mark.skipif(fastparse is None, reason="no C++ toolchain")


def _problems():
    return sorted(glob.glob(os.path.join(CASES_DIR, "*", "problem*.md")))


@pytest.mark.parametrize("path", _problems(), ids=lambda p: os.path.basename(os.path.dirname(p)))
def test_native_matches_python(path):
    txt = open(path).read()
    py = _parse_problem_py(txt)
    nat = _problem_from_native(fastparse.parse(txt))
    assert nat.inner_points == py.inner_points
    assert nat.inner_circles == py.inner_circles
    assert nat.inner_arcs == py.inner_arcs
    assert nat.inner_lines == py.inner_lines
    assert nat.point_guesses == py.point_guesses
    assert nat.scalar_guesses == py.scalar_guesses
    assert len(nat.instructions) == len(py.instructions)
    for a, b in zip(nat.instructions, py.instructions):
        assert a.op == b.op
        assert a.labels == b.labels
        assert (a.value is None) == (b.value is None)
        if a.value is not None:
            assert abs(a.value - b.value) < 1e-12
        assert a.component == b.component
        if a.angle is not None or b.angle is not None:
            assert abs(a.angle.to_radians() - b.angle.to_radians()) < 1e-12


@pytest.mark.parametrize(
    "bad",
    [
        "no header at all\n",
        "# constraints\nfrobnicate(p)\n\n# guesses\np roughly (0,0)\n",
        "# constraints\npoint p\n\n# guesses\np roughly nonsense\n",
        "# constraints\ndistance(a, b)\n\n# guesses\na roughly (0,0)\n",
    ],
)
def test_native_rejects_bad_input(bad):
    with pytest.raises(ValueError):
        fastparse.parse(bad)


def test_native_is_faster_on_big_files():
    import time

    txt = open(os.path.join(CASES_DIR, "massive_parallel_system", "problem.md")).read()
    t0 = time.perf_counter()
    for _ in range(5):
        fastparse.parse(txt)
    t_native = (time.perf_counter() - t0) / 5
    t0 = time.perf_counter()
    _parse_problem_py(txt)
    t_py = time.perf_counter() - t0
    assert t_native < t_py  # typically 10-30x faster
