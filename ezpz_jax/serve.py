"""Production serving: an in-process solver service with micro-batching,
plus a small stdlib HTTP front end.

The reference's embedding story is a WASM build for browsers
(``ezpz-wasm/``); the accelerator equivalent is a service that keeps compiled
topologies warm and batches concurrent same-topology requests into one
vmapped solve — the fleet path is exactly the serving fast path.

No external dependencies: ``http.server`` + threads. For real deployments
put this behind a proper ASGI gateway; the batching core is transport-
agnostic.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np


def hello() -> str:
    """Smoke-test export (mirrors ezpz-wasm's ``hello()``)."""
    return "ezpz_jax: constraint solver ready"


@dataclass
class SolveRequest:
    problem_text: str
    # Per-request precision override ("f64" / "mixed"); None = service
    # default. Large-coordinate sketches that need reference-exact iteration
    # counts can force "f64" even when the service default is mixed.
    precision: Optional[str] = None
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[dict] = None
    error: Optional[str] = None


class SolverService:
    """Parses textual problems, caches compiled topologies, micro-batches
    same-topology requests arriving within ``batch_window_ms``.

    >>> svc = SolverService(batch_window_ms=1.0)
    >>> out = svc.solve_text('''
    ... # constraints
    ... point p
    ... p.x = 0
    ... p.y = 0
    ...
    ... # guesses
    ... p roughly (0.2, -0.1)
    ... ''')
    >>> svc.shutdown()
    >>> out["converged"], out["precision"], out["iterations_comparable"]
    (True, 'f64', True)
    >>> all(abs(v) < 1e-6 for v in out["points"]["p"])
    True
    """

    def __init__(self, batch_window_ms: float = 2.0, max_batch: int = 4096,
                 precision: str = "auto"):
        """``precision``: "f64", "mixed", or "auto" (default). "auto" is the
        reference-exact f64 path; "mixed" (f32 LM + f64-residual
        refinement, verified to the same 1e-8 tolerance, iteration counts
        not comparable to the pure-f64 path) stays an explicit choice."""
        from .config import Config

        assert precision in ("auto", "f64", "mixed"), precision
        if precision == "auto":
            precision = "f64"
        self.precision = precision
        self.config = Config()
        self.batch_window = batch_window_ms / 1000.0
        self.max_batch = max_batch
        self._queue: "queue.Queue[SolveRequest]" = queue.Queue()
        self._solvers: Dict[tuple, object] = {}
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()
        self.stats = {"requests": 0, "batches": 0, "batched_requests": 0}

    # -- public API ---------------------------------------------------------

    def solve_text(self, problem_text: str, timeout: float = 120.0,
                   precision: Optional[str] = None) -> dict:
        if precision is not None and precision not in ("f64", "mixed"):
            raise ValueError(f"precision must be 'f64' or 'mixed', got {precision!r}")
        req = SolveRequest(problem_text=problem_text, precision=precision)
        self._queue.put(req)
        if not req.done.wait(timeout):
            raise TimeoutError("solve timed out")
        if req.error is not None:
            raise ValueError(req.error)
        assert req.result is not None
        return req.result

    def shutdown(self) -> None:
        self._stop.set()
        self._queue.put(None)  # type: ignore[arg-type]
        self._worker.join(timeout=5)

    # -- batching core -------------------------------------------------------

    def _run(self) -> None:
        while not self._stop.is_set():
            first = self._queue.get()
            if first is None:
                break
            batch = [first]
            deadline = time.monotonic() + self.batch_window
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    self._stop.set()
                    break
                batch.append(nxt)
            self._process(batch)

    def _process(self, batch: List[SolveRequest]) -> None:
        # Group by topology signature; same-topology requests solve as one
        # vmapped batch with per-request params/guesses.
        from .models.compiled import topology_key
        from .textual import Problem

        groups: Dict[tuple, List[Tuple[SolveRequest, object]]] = {}
        for req in batch:
            self.stats["requests"] += 1
            try:
                cs = Problem.from_str(req.problem_text).to_constraint_system()
                constraints = [r.constraint for r in cs.constraints]
                # Resolve tangency sides before keying (data-dependent).
                dense = [0.0] * len(cs.initial_guesses)
                for vid, val in cs.initial_guesses:
                    dense[vid] = val
                constraints = [c.set_from_initial_values(dense) for c in constraints]
                # Precision is part of the group key: a batch solves on ONE
                # path, so f64-override requests must not mix into a mixed
                # batch (and vice versa).
                prec = req.precision or self.precision
                key = (_structure_key(constraints, len(cs.initial_guesses)), prec)
                groups.setdefault(key, []).append((req, (cs, constraints)))
            except Exception as e:  # parse/build errors answer immediately
                req.error = str(e)
                req.done.set()

        for key, items in groups.items():
            try:
                self._solve_group(key, items)
            except Exception as e:
                for req, _ in items:
                    req.error = str(e)
                    req.done.set()

    def _solve_group(self, key, items) -> None:
        import jax.numpy as jnp

        from .batch import BatchSolver
        from .models.compiled import compile_system

        self.stats["batches"] += 1
        self.stats["batched_requests"] += len(items)

        cs0, constraints0 = items[0][1]
        precision = key[1]
        n_vars = len(cs0.initial_guesses)
        solver = self._solvers.get(key)
        if solver is None:
            system = compile_system(constraints0, n_vars)
            solver = (
                BatchSolver(system, self.config, batch_params=True,
                            precision=precision),
                system,
            )
            self._solvers[key] = solver
        batch_solver, system = solver

        B = len(items)
        x0 = np.zeros((B, n_vars))
        pars_list = []
        for i, (_req, (cs, constraints)) in enumerate(items):
            for vid, val in cs.initial_guesses:
                x0[i, vid] = val
            by_kind: Dict[str, list] = {}
            for c in constraints:
                for inst in c.lower():
                    by_kind.setdefault(inst.kernel, []).append(inst.params)
            pars_list.append(by_kind)
        pars = tuple(
            jnp.asarray(
                np.stack([
                    np.asarray(pl[b.spec.name], dtype=np.float64).reshape(
                        len(pl[b.spec.name]), b.spec.nparams
                    )
                    for pl in pars_list
                ])
            )
            for b in system.blocks
        )

        res = batch_solver.solve(jnp.asarray(x0), pars)
        xs = np.asarray(res.x)
        iters = np.asarray(res.iterations)
        conv = np.asarray(res.converged)
        sat = np.asarray(res.satisfied)
        for i, (req, (cs, _)) in enumerate(items):
            req.result = _format_outcome(
                cs, xs[i], int(iters[i]), bool(conv[i]), sat[i],
                precision=precision,
            )
            req.done.set()


def _structure_key(constraints, n_vars: int) -> tuple:
    """Topology signature excluding params (they batch)."""
    items = []
    for c in constraints:
        for inst in c.lower():
            items.append((inst.kernel, inst.var_ids))
    return (n_vars, tuple(items))


def _format_outcome(cs, x: np.ndarray, iterations: int, converged: bool, sat,
                    precision: str = "f64") -> dict:
    from .textual.executor import VARS_PER_ARC, VARS_PER_CIRCLE, VARS_PER_POINT

    points = {}
    for i, label in enumerate(cs.inner_points):
        points[label] = [float(x[2 * i]), float(x[2 * i + 1])]
    start_c = VARS_PER_POINT * len(cs.inner_points)
    circles = {}
    for i, label in enumerate(cs.inner_circles):
        base = start_c + VARS_PER_CIRCLE * i
        circles[label] = {
            "center": [float(x[base]), float(x[base + 1])],
            "radius": float(x[base + 2]),
        }
    start_a = start_c + VARS_PER_CIRCLE * len(cs.inner_circles)
    arcs = {}
    for i, label in enumerate(cs.inner_arcs):
        base = start_a + VARS_PER_ARC * i
        arcs[label] = {
            "a": [float(x[base]), float(x[base + 1])],
            "b": [float(x[base + 2]), float(x[base + 3])],
            "center": [float(x[base + 4]), float(x[base + 5])],
        }
    unsat = [int(i) for i in np.nonzero(~np.asarray(sat))[0]]
    return {
        "converged": converged,
        "iterations": iterations,
        # Which solve path produced this answer. Mixed-precision iteration
        # counts (coarse f32 + f64 refine steps) are NOT comparable to the
        # reference's pure-f64 LM counts; ``iterations_comparable`` says so
        # explicitly so clients can't mistake one for the other.
        "precision": precision,
        "iterations_comparable": precision == "f64",
        "unsatisfied": unsat,
        "points": points,
        "circles": circles,
        "arcs": arcs,
    }


def benchmark(n: int = 100) -> float:
    """Times n sequential service solves of the two-rectangles system and
    returns solves/sec (mirrors ezpz-wasm's ``benchmark()``)."""
    import os

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(here, "tests", "cases", "two_rectangles", "problem.md")
    txt = open(path).read()
    svc = SolverService()
    svc.solve_text(txt)  # warm
    t0 = time.perf_counter()
    for _ in range(n):
        svc.solve_text(txt)
    dt = time.perf_counter() - t0
    svc.shutdown()
    return n / dt


# -- HTTP front end ----------------------------------------------------------


def make_handler(service: "SolverService"):
    """The HTTP handler class bound to ``service`` — factored out of
    ``run_server`` so tests exercise the REAL production handler (routes,
    X-Precision header, error bodies) rather than a reimplementation."""
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def do_GET(self):
            if self.path == "/healthz":
                body = json.dumps({"ok": True, **service.stats}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self.send_response(404)
                self.end_headers()

        def do_POST(self):
            if self.path != "/solve":
                self.send_response(404)
                self.end_headers()
                return
            length = int(self.headers.get("Content-Length", "0"))
            text = self.rfile.read(length).decode()
            # Per-request path selection: "X-Precision: f64" forces the
            # reference-exact pure-f64 path (comparable iteration counts,
            # robust for large-coordinate sketches); "mixed" forces the
            # high-throughput path. Absent = service default.
            precision = self.headers.get("X-Precision") or None
            try:
                result = service.solve_text(text, precision=precision)
                body = json.dumps(result).encode()
                code = 200
            except Exception as e:
                body = json.dumps({"error": str(e)}).encode()
                code = 400
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    return Handler


def run_server(host: str = "127.0.0.1", port: int = 8787) -> None:
    """POST /solve with a textual problem body -> JSON outcome.
    GET /healthz -> service stats."""
    from http.server import ThreadingHTTPServer

    from . import enable_compilation_cache

    enable_compilation_cache()  # warm restarts skip topology recompiles
    service = SolverService()
    server = ThreadingHTTPServer((host, port), make_handler(service))
    print(f"ezpz_jax serving on http://{host}:{port} (POST /solve)")
    try:
        server.serve_forever()
    finally:
        service.shutdown()


def main(argv=None) -> int:
    """Console entry point: ``ezpz-serve [port]``."""
    import sys

    args = sys.argv[1:] if argv is None else argv
    port = int(args[0]) if args else 8787
    run_server(port=port)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
