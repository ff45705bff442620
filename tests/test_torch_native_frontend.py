"""The port's native front end (ssad_tpu_torch/serving/native_frontend.py +
native/http_frontend.cpp) against the JAX package's
(ssad_tpu/serving/native_frontend.py; its own tests:
tests/test_native_frontend.py).

Every case of the JAX file runs here on both servers, each over its own
package's ``BatchingScorer`` and the same stub scorer, with the same raw
request bytes: routes (``/score``, ``/healthz``, ``/readyz``, ``/stats``,
``/metrics``), a keep-alive client, a 400 body, 404 routes, several
models, the patch heatmap, a malformed request line (400), a chunked
body (411), an oversized one (413), ``Expect: 100-continue``, pipelined
requests (answered in order), request + FIN, negative or garbage
Content-Length (400), transport shedding while Python is slow, a
concurrent burst with no resets, a scoring timeout (504), drift through
the shared helpers, the poller surviving a handler exception, an
overflow while a request is in flight (200 before 413), and two
pipelined in-bound requests larger together than the read buffer.

Limit: the status codes and the JSON bodies are equal, apart from the
latency fields (``ms``, ``latency_ms_p50``/``_p95``, the latency
quantiles of ``/metrics``) and object addresses inside an error's repr
(``<... at 0x7f…>``).  Where timing decides which request is shed (the
slow-Python case) or which requests share a batch (bursts), both servers
are held to the same invariant instead.  Skipped, as the JAX file is,
where g++ cannot build the library.

Planted faults that break these: the port's poller without its
per-request guard (the resilience case: the next GET never answers), a
504 body that differs from JAX's (the timeout case), and ``/metrics``
sent as a JSON string (the routes case).
"""

from __future__ import annotations

import contextlib
import io
import json
import re
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from ssad_tpu.serving import drift as jdrift
from ssad_tpu.serving import native_frontend as jnative
from ssad_tpu.serving import server as jserver
from ssad_tpu_torch.serving import drift as pdrift
from ssad_tpu_torch.serving import native_frontend as pnative
from ssad_tpu_torch.serving import server as pserver

pytestmark = pytest.mark.skipif(
    not (pnative.available() and jnative.available()),
    reason="native HTTP front end not buildable here",
)
PACKAGES = {"port": (pserver, pnative, pdrift), "jax": (jserver, jnative, jdrift)}
IMAGE_META = {"mode": "image", "imsize": [8, 8], "threshold": 100.0}
DROP = {"ms", "latency_ms_p50", "latency_ms_p95"}


def _sum_scorer(x):
    s = x.reshape(x.shape[0], -1).sum(axis=1)
    return s, (s > 100).astype(np.int32)


def _npy(img):
    buf = io.BytesIO()
    np.save(buf, img)
    return buf.getvalue()


ONES, HALVES = (_npy(np.full((8, 8, 3), v, np.float32)) for v in (1.0, 0.5))


@contextlib.contextmanager
def pair(spec=None, max_body=None, **kw):
    """Both packages' native servers, started over the same stubs: spec is
    {name: (scorer fn, batcher kwargs, meta)}; ``max_body`` rebuilds the
    transport with that body bound (as the JAX file does)."""
    spec = spec or {"default": (_sum_scorer, {"batch": 4, "max_delay_ms": 5.0}, IMAGE_META)}
    servers = {}
    try:
        for which, (server_mod, native_mod, _) in PACKAGES.items():
            models = {name: (server_mod.BatchingScorer(fn, **bkw), dict(meta))
                      for name, (fn, bkw, meta) in spec.items()}
            srv = native_mod.NativeAnomalyHTTPServer(models=models, port=0, **kw)
            if max_body is not None:
                srv._lib.nhf_destroy(srv._handle)
                srv._handle = srv._lib.nhf_create(b"127.0.0.1", 0, 1024, max_body)
            servers[which] = srv.start()
        yield servers
    finally:
        for srv in servers.values():
            srv.stop()


def _norm(value):
    if isinstance(value, dict):
        return {k: _norm(v) for k, v in value.items() if k not in DROP}
    if isinstance(value, list):
        return [_norm(v) for v in value]
    if isinstance(value, str):
        return re.sub(r"0x[0-9a-f]+", "0x?", value)
    return value


def parse(buf: bytes) -> list:
    """A raw response stream → [(status, {header: value}, body)], complete
    responses only (a 100 Continue has no body)."""
    out = []
    while b"\r\n\r\n" in buf:
        head, _, rest = buf.partition(b"\r\n\r\n")
        lines = head.decode("latin-1").split("\r\n")
        headers = dict(line.split(": ", 1) for line in lines[1:] if ": " in line)
        headers = {k.lower(): v for k, v in headers.items()}
        n = int(headers.get("content-length", 0))
        if len(rest) < n:
            break
        out.append((int(lines[0].split()[1]), headers, rest[:n]))
        buf = rest[n:]
    return out


def raw(port, payload: bytes, responses: int = 1, fin: bool = False, then=None) -> list:
    """Send ``payload`` (and ``then`` 0.1 s later) on one socket; read
    until ``responses`` final responses arrived, the peer closed or 10 s
    passed → parse()."""
    s = socket.create_connection(("127.0.0.1", port), timeout=10)
    s.sendall(payload)
    if then is not None:
        time.sleep(0.1)
        s.sendall(then)
    if fin:
        s.shutdown(socket.SHUT_WR)
    buf = b""
    try:
        while len([r for r in parse(buf) if r[0] != 100]) < responses:
            got = s.recv(65536)
            if not got:
                break
            buf += got
    except socket.timeout:
        pass
    s.close()
    return parse(buf)


def bodies(responses) -> list:
    """(status, normalised JSON body or raw text) per response."""
    out = []
    for status, _, body in responses:
        try:
            out.append((status, _norm(json.loads(body))))
        except ValueError:
            out.append((status, body.decode("latin-1")))
    return out


def both(servers, fn):
    """fn(server) on both servers → (port's, JAX's)."""
    return fn(servers["port"]), fn(servers["jax"])


def _post_req(path, body, extra=""):
    return (f"POST {path} HTTP/1.1\r\nHost: x\r\n{extra}Content-Length: {len(body)}\r\n\r\n"
            ).encode() + body


def _get_req(path):
    return f"GET {path} HTTP/1.1\r\nHost: x\r\n\r\n".encode()


def _http(port, method, path, body=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body, method=method)
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


# -- routes ------------------------------------------------------------------------------


def test_routes_answer_as_jax():
    with pair() as servers:
        def session(srv):
            got = [raw(srv.port, _post_req("/score", ONES))[0]]
            got += [raw(srv.port, _get_req(p))[0] for p in ("/healthz", "/readyz", "/stats")]
            metrics = raw(srv.port, _get_req("/metrics"))[0]
            ts = srv.transport_stats()
            return bodies(got), metrics, ts

        (port, pmetrics, pts), (jax_, jmetrics, jts) = both(servers, session)
    assert port == jax_
    assert port[0] == (200, {"score": 192.0, "label": 1, "threshold": 100.0})
    assert port[1] == (200, {"ok": True, "mode": "image"})
    assert port[2] == (200, {"ready": True})
    assert port[3][1]["requests"] >= 1 and port[3][1]["scores"]["recent_n"] == 1
    assert pmetrics[0] == jmetrics[0] == 200
    strip = [re.sub(r"^(ssad_request_latency_ms\{[^}]*\}) .*$", r"\1", line)
             for line in pmetrics[2].decode().splitlines()]
    jstrip = [re.sub(r"^(ssad_request_latency_ms\{[^}]*\}) .*$", r"\1", line)
              for line in jmetrics[2].decode().splitlines()]
    assert strip == jstrip and "ssad_requests_total" in pmetrics[2].decode()
    for key in ("connections", "requests", "responses", "protocol_errors", "shed_transport"):
        assert pts[key] == jts[key], key
    assert pts["requests"] >= 5 and pts["protocol_errors"] == 0


def test_client_library_keepalive():
    from ssad_tpu_torch.serving.client import ServingClient

    with pair() as servers:
        def session(srv):
            cl = ServingClient(f"http://127.0.0.1:{srv.port}")
            a = cl.score(np.full((8, 8, 3), 1.0, np.float32))
            conn = cl._local.conn
            b = cl.score(np.full((8, 8, 3), 0.5, np.float32))
            ts = srv.transport_stats()
            return _norm(a), _norm(b), cl._local.conn is conn, ts["connections"], ts["requests"]

        port, jax_ = both(servers, session)
    assert port == jax_
    assert port[0]["score"] == 192.0 and port[1]["score"] == 96.0
    assert port[2] and port[3] <= 2 and port[4] >= 2


def test_bad_body_is_400():
    with pair() as servers:
        port, jax_ = both(servers, lambda s: bodies(raw(s.port, _post_req("/score",
                                                                          b"not an image"))))
    assert port == jax_ and port[0][0] == 400 and "error" in port[0][1]


def test_unknown_routes_are_404():
    with pair() as servers:
        port, jax_ = both(servers, lambda s: bodies(
            raw(s.port, _get_req("/nope")) + raw(s.port, _post_req("/score/ghost", b"x"))
            + raw(s.port, b"PUT /score HTTP/1.1\r\nHost: x\r\nContent-Length: 0\r\n\r\n")))
    assert port == jax_ and [code for code, _ in port] == [404, 404, 404]


def test_multi_model_routing():
    def double_scorer(x):
        s = 2 * x.reshape(x.shape[0], -1).sum(axis=1)
        return s, (s > 100).astype(np.int32)

    meta = {"mode": "image", "imsize": [8, 8], "threshold": 1.0}
    spec = {"a": (_sum_scorer, {"batch": 2, "max_delay_ms": 2.0}, meta),
            "b": (double_scorer, {"batch": 2, "max_delay_ms": 2.0}, meta)}
    with pair(spec) as servers:
        def session(srv):
            got = [raw(srv.port, _post_req(p, ONES))[0] for p in ("/score/a", "/score/b",
                                                                  "/score")]
            got += [raw(srv.port, _get_req(p))[0] for p in ("/healthz", "/stats")]
            return bodies(got)

        port, jax_ = both(servers, session)
    assert port == jax_
    assert port[0][1]["score"] == 192 and port[1][1]["score"] == 384
    assert port[2][0] == 400 and port[2][1]["models"] == ["a", "b"]
    assert set(port[4][1]) == {"a", "b"}


def test_patch_mode_heatmap():
    def map_scorer(x):
        return (x.mean(axis=-1),)

    img = np.random.default_rng(0).uniform(size=(8, 8, 3)).astype(np.float32)
    spec = {"default": (map_scorer, {"batch": 2, "max_delay_ms": 5.0},
                        {"mode": "patch", "imsize": [8, 8]})}
    with pair(spec) as servers:
        port, jax_ = both(servers, lambda s: bodies(
            raw(s.port, _post_req("/score?heatmap=1", _npy(img)))
            + raw(s.port, _post_req("/score", _npy(img)))))
    assert port == jax_
    assert port[0][1]["map_max"] == pytest.approx(float(img.mean(-1).max()), rel=1e-6)
    assert "heatmap_b64" in port[0][1] and "heatmap_b64" not in port[1][1]


# -- protocol ------------------------------------------------------------------------------


@pytest.mark.parametrize("payload,code", [
    (b"GARBAGE\r\n\r\n", 400),
    (b"POST /score HTTP/1.1\r\nHost: x\r\nTransfer-Encoding: chunked\r\n\r\n", 411),
    (b"POST /score HTTP/1.1\r\nHost: x\r\nContent-Length: -5\r\n\r\n", 400),
    (b"POST /score HTTP/1.1\r\nHost: x\r\nContent-Length: 12abc\r\n\r\n", 400),
], ids=["malformed_request_line", "chunked", "negative_length", "garbage_length"])
def test_protocol_errors(payload, code):
    with pair() as servers:
        port, jax_ = both(servers, lambda s: (raw(s.port, payload), s.transport_stats()))
    assert [(c, h.get("connection"), b) for c, h, b in port[0]] == \
        [(c, h.get("connection"), b) for c, h, b in jax_[0]]
    assert port[0][0][0] == code
    assert port[1]["protocol_errors"] == jax_[1]["protocol_errors"] == 1
    if code == 411:
        assert port[0][0][1].get("connection") == "close"


def test_oversized_body_is_413():
    with pair(max_body=1024) as servers:
        port, jax_ = both(servers, lambda s: bodies(raw(
            s.port, b"POST /score HTTP/1.1\r\nHost: x\r\nContent-Length: 999999\r\n\r\n")))
    assert port == jax_ and port[0][0] == 413


def test_expect_100_continue():
    head = (f"POST /score HTTP/1.1\r\nHost: x\r\nExpect: 100-continue\r\n"
            f"Content-Length: {len(ONES)}\r\n\r\n").encode()
    with pair() as servers:
        def session(srv):
            s = socket.create_connection(("127.0.0.1", srv.port), timeout=10)
            s.sendall(head)
            first = s.recv(1024)
            s.sendall(ONES)
            rest = b""
            while len(parse(rest)) < 1:
                got = s.recv(65536)
                if not got:
                    break
                rest += got
            s.close()
            return first, bodies(parse(rest))

        port, jax_ = both(servers, session)
    assert port == jax_
    assert port[0].startswith(b"HTTP/1.1 100 Continue") and port[1][0][1]["score"] == 192.0


def test_pipelined_requests_answered_in_order():
    with pair() as servers:
        port, jax_ = both(servers, lambda s: bodies(raw(
            s.port, _post_req("/score", ONES) + _post_req("/score", HALVES), responses=2)))
    assert port == jax_
    assert [b["score"] for _, b in port] == [192.0, 96.0]


def test_request_plus_fin_still_answered():
    with pair() as servers:
        port, jax_ = both(servers, lambda s: bodies(raw(s.port, _post_req("/score", ONES),
                                                        fin=True)))
    assert port == jax_ and port[0] == (200, {"score": 192.0, "label": 1, "threshold": 100.0})


def test_scoring_timeout_is_504():
    def stuck(x):
        time.sleep(0.6)
        return _sum_scorer(x)

    spec = {"default": (stuck, {"batch": 1, "max_delay_ms": 0.1}, IMAGE_META)}
    with pair(spec, score_timeout=0.2) as servers:
        port, jax_ = both(servers, lambda s: bodies(raw(s.port, _post_req("/score", ONES))))
    assert port == jax_ == [(504, {"error": "scoring timed out"})]


def test_transport_sheds_when_python_is_slow():
    def slow(x):
        time.sleep(0.3)
        return _sum_scorer(x)

    spec = {"default": (slow, {"batch": 1, "max_delay_ms": 0.1, "max_queue": None},
                        {"mode": "image", "imsize": [8, 8], "threshold": 1.0})}
    with pair(spec, max_queue=1) as servers:
        def burst(srv):
            codes, lock = [], threading.Lock()

            def hit():
                code, _ = _http(srv.port, "POST", "/score", ONES)
                with lock:
                    codes.append(code)

            threads = [threading.Thread(target=hit) for _ in range(12)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            return codes

        port, jax_ = both(servers, burst)
    for codes in (port, jax_):
        assert len(codes) == 12 and set(codes) <= {200, 503} and 200 in codes


def test_concurrent_burst_no_resets():
    with pair() as servers:
        def burst(srv):
            out, lock = [], threading.Lock()

            def hit():
                try:
                    code, body = _http(srv.port, "POST", "/score", ONES)
                    got = (code, _norm(json.loads(body)))
                except Exception as e:  # a reset is a failure, recorded
                    got = (None, repr(e))
                with lock:
                    out.append(got)

            threads = [threading.Thread(target=hit) for _ in range(24)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            return out

        port, jax_ = both(servers, burst)
    want = [(200, {"score": 192.0, "label": 1, "threshold": 100.0})] * 24
    assert port == jax_ == want


def test_drift_tracking_via_shared_semantics():
    baseline = pdrift.quantile_summary(np.random.default_rng(0).normal(96.0, 2.0, 500))
    assert baseline == jdrift.quantile_summary(np.random.default_rng(0).normal(96.0, 2.0, 500))
    meta = {"mode": "image", "imsize": [8, 8], "threshold": 150.0, "calibration": baseline}
    with pair({"default": (_sum_scorer, {"batch": 4, "max_delay_ms": 2.0}, meta)}) as servers:
        def session(srv):
            srv.trackers["default"].min_scores = 8
            for _ in range(8):
                raw(srv.port, _post_req("/score", ONES))
            return bodies(raw(srv.port, _get_req("/stats")))[0][1]["scores"]

        port, jax_ = both(servers, session)
    assert port == jax_
    assert port["drift_ks"] == pytest.approx(1.0) and port["drift_alert"] is True


# -- poller resilience and the transport's buffer ---------------------------------------------


def test_poller_survives_handler_exception(monkeypatch):
    def boom(models, trackers):
        raise KeyError("torn reload snapshot")

    with pair() as servers:
        monkeypatch.setattr(pserver, "build_stats", boom)
        monkeypatch.setattr(jserver, "build_stats", boom)
        failed = both(servers, lambda s: bodies(raw(s.port, _get_req("/stats"))))
        monkeypatch.undo()
        after = both(servers, lambda s: bodies(raw(s.port, _get_req("/healthz"))
                                               + raw(s.port, _get_req("/stats"))))
    assert failed[0] == failed[1] == [(500, {"error": "KeyError('torn reload snapshot')"})]
    assert after[0] == after[1]
    assert after[0][0] == (200, {"ok": True, "mode": "image"}) and "requests" in after[0][1][1]


def test_overflow_while_inflight_preserves_ordering():
    def slow_sum(x):
        time.sleep(0.5)
        return _sum_scorer(x)

    spec = {"default": (slow_sum, {"batch": 1, "max_delay_ms": 1.0}, IMAGE_META)}
    oversized = b"POST /score HTTP/1.1\r\nHost: x\r\nContent-Length: 999999\r\n\r\n" + \
        b"x" * 30000
    with pair(spec, max_body=1024) as servers:
        port, jax_ = both(servers, lambda s: bodies(raw(
            s.port, _post_req("/score", ONES), responses=2, then=oversized)))
    assert port == jax_
    assert [code for code, _ in port] == [200, 413] and port[0][1]["score"] == 192.0


def test_pipelined_inlimit_requests_exceeding_rbuf_both_answered():
    body = _npy(np.full((40, 40, 3), 0.25, np.float32))
    spec = {"default": (_sum_scorer, {"batch": 1, "max_delay_ms": 1.0},
                        {"mode": "image", "imsize": [40, 40], "threshold": 1e9})}
    with pair(spec, max_body=20000) as servers:
        port, jax_ = both(servers, lambda s: bodies(raw(
            s.port, _post_req("/score", body) * 2, responses=2)))
    assert port == jax_ and [code for code, _ in port] == [200, 200]
