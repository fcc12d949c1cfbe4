"""Serving layer tests: micro-batching service + HTTP front end."""

import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from ezpz_jax import serve

from .helpers import CASES_DIR


def _txt(name):
    import os

    return open(os.path.join(CASES_DIR, name, "problem.md")).read()


def test_hello():
    assert "ready" in serve.hello()


def test_service_single_solve():
    svc = serve.SolverService()
    try:
        out = svc.solve_text(_txt("tiny"))
        assert out["converged"]
        assert abs(out["points"]["q"][0]) < 1e-4
        assert abs(out["points"]["q"][1]) < 1e-4
        # The response declares which solve path ran (CPU default: f64,
        # whose iteration counts are reference-comparable).
        assert out["precision"] in ("f64", "mixed")
        assert out["iterations_comparable"] == (out["precision"] == "f64")
    finally:
        svc.shutdown()


def test_service_batches_concurrent_same_topology():
    svc = serve.SolverService(batch_window_ms=50.0)
    txt = _txt("two_rectangles")
    svc.solve_text(txt)  # warm compile so the batch window isn't starved
    results = [None] * 8
    errors = []

    def work(i):
        try:
            results[i] = svc.solve_text(txt)
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    svc.shutdown()
    assert not errors
    assert all(r is not None and r["converged"] for r in results)
    # The 8 concurrent requests must have shared batches.
    assert svc.stats["batches"] < svc.stats["requests"]


def test_service_mixed_precision():
    """precision='mixed' (an explicit choice; 'auto' is f64) serves the same
    solutions at the f64-verified tolerance."""
    from ezpz_jax.serve import SolverService

    svc = SolverService(batch_window_ms=1.0, precision="mixed")
    try:
        out = svc.solve_text(_txt("tiny"))
        assert out["converged"]
        assert not out["unsatisfied"]
        assert "points" in out
        # Mixed-path responses are labeled: their iteration counts are NOT
        # comparable to reference-pinned pure-f64 counts.
        assert out["precision"] == "mixed"
        assert out["iterations_comparable"] is False
    finally:
        svc.shutdown()


def test_service_per_request_precision_override():
    """A request can force the pure-f64 path on a mixed-default service
    (e.g. large-coordinate sketches, or reference-comparable iteration
    counts)."""
    svc = serve.SolverService(batch_window_ms=1.0, precision="mixed")
    try:
        out = svc.solve_text(_txt("tiny"), precision="f64")
        assert out["converged"]
        assert out["precision"] == "f64"
        assert out["iterations_comparable"] is True
        with pytest.raises(ValueError):
            svc.solve_text(_txt("tiny"), precision="f128")
    finally:
        svc.shutdown()


def test_service_parse_error():
    svc = serve.SolverService()
    try:
        with pytest.raises(ValueError):
            svc.solve_text("# constraints\nbogus(p)\n\n# guesses\np roughly (0,0)\n")
    finally:
        svc.shutdown()


def test_http_server_roundtrip():
    """The PRODUCTION handler (serve.make_handler) on an ephemeral port:
    solve roundtrip, /healthz stats, 404 routes, the X-Precision header,
    and the 400 error body for an unparseable problem."""
    from http.server import ThreadingHTTPServer

    import ezpz_jax.serve as sv

    service = sv.SolverService()
    server = ThreadingHTTPServer(("127.0.0.1", 0), sv.make_handler(service))
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{port}"
    try:
        req = urllib.request.Request(
            f"{base}/solve", data=_txt("tiny").encode(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as resp:
            out = json.loads(resp.read())
        assert out["converged"]

        # X-Precision header forces the reference-exact path.
        req = urllib.request.Request(
            f"{base}/solve", data=_txt("tiny").encode(), method="POST",
            headers={"X-Precision": "f64"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            out = json.loads(resp.read())
        assert out["precision"] == "f64" and out["iterations_comparable"]

        # /healthz reports stats.
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as resp:
            health = json.loads(resp.read())
        assert health["ok"] and health["requests"] >= 2

        # Unknown routes 404 (GET and POST).
        for method, path in (("GET", "/nope"), ("POST", "/nope")):
            req = urllib.request.Request(
                f"{base}{path}", data=b"x" if method == "POST" else None,
                method=method)
            try:
                urllib.request.urlopen(req, timeout=30)
                assert False, "expected 404"
            except urllib.error.HTTPError as e:
                assert e.code == 404

        # Unparseable body -> 400 with a JSON error payload.
        req = urllib.request.Request(
            f"{base}/solve", data=b"this is not a problem", method="POST")
        try:
            urllib.request.urlopen(req, timeout=120)
            assert False, "expected 400"
        except urllib.error.HTTPError as e:
            assert e.code == 400
            assert "error" in json.loads(e.read())
    finally:
        server.shutdown()
        service.shutdown()
