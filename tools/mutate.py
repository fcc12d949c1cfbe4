"""Minimal AST-based mutation testing (the `cargo mutants` analog,
``/root/reference/justfile:107-110``, ``.cargo/mutants.toml``).

No Python mutation tool ships in this image (and there is no network), so
this is a small, self-contained mutant generator + runner:

* Parse the target module, enumerate single-node mutations (arithmetic
  operator swaps, comparison swaps, boolean swaps, numeric-literal
  perturbations, ``and``/``or`` flips).
* For each mutant: write the mutated source in place (original restored in
  a ``finally``), run the given pytest selection with ``-x`` (first failure
  kills the mutant fast), record killed/survived.
* Report a kill rate and list every surviving mutant with its diff line.

Usage:
    python tools/mutate.py ezpz_jax/solver.py -- tests/test_solver_edges.py
    python tools/mutate.py ezpz_jax/ops/kernels.py --sample 40 -- \
        tests/test_properties.py -k jacobian

Notes: runs are sequential (single host core) and each mutant pays cold
jit compiles — use targeted, fast test selections. ``--sample N`` takes a
deterministic every-k-th subsample for bounded runs.
"""

from __future__ import annotations

import argparse
import ast
import copy
import subprocess
import sys
import time

ARITH = {
    ast.Add: ast.Sub, ast.Sub: ast.Add,
    ast.Mult: ast.Div, ast.Div: ast.Mult,
}
COMPARE = {
    ast.Lt: ast.LtE, ast.LtE: ast.Lt,
    ast.Gt: ast.GtE, ast.GtE: ast.Gt,
    ast.Eq: ast.NotEq, ast.NotEq: ast.Eq,
}
BOOL = {ast.And: ast.Or, ast.Or: ast.And}


def _describe(node: ast.AST, change: str) -> str:
    return f"line {node.lineno}: {change}"


def enumerate_mutants(tree: ast.Module):
    """Yield (description, mutated_tree). Each mutant changes ONE node."""
    # Index nodes by a stable walk order so we can re-locate them in a copy.
    for i, node in enumerate(ast.walk(tree)):
        mutations = []
        if isinstance(node, ast.BinOp) and type(node.op) in ARITH:
            new_op = ARITH[type(node.op)]
            mutations.append((f"{type(node.op).__name__} -> {new_op.__name__}",
                              ("op", new_op)))
        elif isinstance(node, ast.Compare) and len(node.ops) == 1 \
                and type(node.ops[0]) in COMPARE:
            new_op = COMPARE[type(node.ops[0])]
            mutations.append(
                (f"{type(node.ops[0]).__name__} -> {new_op.__name__}",
                 ("cmp", new_op)))
        elif isinstance(node, ast.BoolOp) and type(node.op) in BOOL:
            new_op = BOOL[type(node.op)]
            mutations.append((f"{type(node.op).__name__} -> {new_op.__name__}",
                              ("op", new_op)))
        elif isinstance(node, ast.Constant) and isinstance(node.value, (int, float)) \
                and not isinstance(node.value, bool) and node.value not in (0, 1, -1, 2):
            # 0/1/-1/2 appear in indexing/shape code; mutating those mostly
            # yields crashes (equivalent-mutant noise), skip them.
            mutations.append((f"{node.value!r} -> {node.value * 10!r}",
                              ("const", node.value * 10)))
        for desc, (kind, payload) in mutations:
            mutated = copy.deepcopy(tree)
            target = list(ast.walk(mutated))[i]
            if kind == "op":
                target.op = payload()
            elif kind == "cmp":
                target.ops = [payload()]
            elif kind == "const":
                target.value = payload
            yield _describe(node, desc), mutated


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--" in argv:
        split = argv.index("--")
        argv, pytest_args = argv[:split], argv[split + 1:]
    else:
        pytest_args = ["tests/", "-q"]
    ap = argparse.ArgumentParser()
    ap.add_argument("target")
    ap.add_argument("--sample", type=int, default=0,
                    help="run only every k-th mutant so ~SAMPLE total run")
    ap.add_argument("--skip", type=int, default=0,
                    help="resume: skip the first N selected mutants (the "
                         "selection order is deterministic, so --skip 26 "
                         "continues an interrupted run at mutant 27)")
    ap.add_argument("--lines", default=None, metavar="A-B",
                    help="mutate only nodes whose line number is in [A, B] "
                         "(targeted runs over one function/region of a "
                         "large module)")
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)

    src = open(args.target).read()
    tree = ast.parse(src)
    mutants = list(enumerate_mutants(tree))
    if args.lines:
        lo, hi = (int(t) for t in args.lines.split("-"))
        mutants = [
            (desc, m) for desc, m in mutants
            if lo <= int(desc.split()[1].rstrip(":")) <= hi
        ]
    step = max(1, len(mutants) // args.sample) if args.sample else 1
    selected = mutants[::step]
    n_all = len(selected)
    selected = selected[args.skip:]
    print(f"{args.target}: {len(mutants)} mutants, running {len(selected)}"
          + (f" (resumed at {args.skip + 1}/{n_all})" if args.skip else ""))

    killed, survived, errored = 0, [], 0
    try:
        for k, (desc, mutated) in enumerate(selected):
            open(args.target, "w").write(ast.unparse(mutated))
            t0 = time.time()
            try:
                proc = subprocess.run(
                    [sys.executable, "-m", "pytest", "-x", "-q",
                     "-p", "no:cacheprovider"] + pytest_args,
                    capture_output=True, timeout=args.timeout)
                rc = proc.returncode
            except subprocess.TimeoutExpired:
                rc = -1  # hang = killed (a mutant that loops forever)
            dt = time.time() - t0
            if rc == 5:
                # pytest "no tests collected": the SELECTION is broken (e.g.
                # a -k expression that also matches the module name), so no
                # mutant is being tested at all. Abort loudly rather than
                # report a vacuous 100% kill rate.
                print(f"FATAL: selection collected no tests (pytest exit 5) "
                      f"for mutant '{desc}' — fix the pytest selection.")
                return 3
            if rc == 0:
                survived.append(desc)
                verdict = "SURVIVED"
            elif rc in (1, -1):
                killed += 1
                verdict = "killed"
            else:  # collection error etc. — mutant broke the import; killed
                killed += 1
                errored += 1
                verdict = "killed (error)"
            print(f"  [{k + 1 + args.skip}/{n_all}] {desc}: {verdict} "
                  f"({dt:.0f}s)", flush=True)
    finally:
        open(args.target, "w").write(src)

    total = len(selected)
    print(f"\nkill rate: {killed}/{total} "
          f"({100.0 * killed / max(total, 1):.0f}%), "
          f"{len(survived)} survived, {errored} import-errors")
    for desc in survived:
        print(f"  SURVIVED: {desc}")
    return 0 if not survived else 2


if __name__ == "__main__":
    sys.exit(main())
