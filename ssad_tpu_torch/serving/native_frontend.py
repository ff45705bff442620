"""Native (C++) serving front end: the ctypes binding and the server class.

Counterpart of ssad_tpu/serving/native_frontend.py:1-345.
``NativeAnomalyHTTPServer`` takes the stdlib ``AnomalyHTTPServer``'s
constructor, routes and payloads (the route semantics live in
serving/server.py's ``build_*`` helpers, ``prometheus_metrics`` and
``perform_reload``) and moves the transport off the GIL into
native/http_frontend.cpp: accept, HTTP/1.1 parsing, keep-alive
sequencing, protocol errors, transport-level load shedding and response
writes run on one C++ epoll thread.  Python sees parsed requests in
batches through one blocking ``nhf_poll`` call (which releases the GIL)
and answers with small JSON bodies.  ``cli serve --frontend native``
selects it; the library is built with g++ at first use
(native/__init__.py) and the CLI falls back loudly to the stdlib front
end when it cannot be.

Threading model:
  C++ epoll thread   — all socket I/O and HTTP framing
  poller thread (py) — drains nhf_poll, answers GET routes inline,
                       decodes POST bodies, submits to the batcher
  responder pool     — /readyz, /admin/reload, and waiting on each
                       request's batch: payload, drift tracker, response
  BatchingScorer     — unchanged (a collector, and a runner per replica)
"""

from __future__ import annotations

import ctypes
import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Tuple

from ssad_tpu_torch import native
from ssad_tpu_torch.serving import server as srv
from ssad_tpu_torch.serving.drift import ScoreTracker

_SRC = native.NATIVE_DIR / "http_frontend.cpp"
_lib: Optional[ctypes.CDLL] = None
_lib_tried = False
_lock = threading.Lock()


class _NhfReq(ctypes.Structure):
    _fields_ = [
        ("id", ctypes.c_int64),
        ("method", ctypes.c_char_p),
        ("path", ctypes.c_char_p),
        ("body", ctypes.POINTER(ctypes.c_char)),
        ("body_len", ctypes.c_int64),
    ]


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_tried
    with _lock:
        if _lib_tried:
            return _lib
        _lib_tried = True
        so = native.build_library(_SRC, "ssadhttp")
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            return None
        lib.nhf_create.restype = ctypes.c_void_p
        lib.nhf_create.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_long]
        lib.nhf_start.restype = ctypes.c_int
        lib.nhf_start.argtypes = [ctypes.c_void_p]
        lib.nhf_poll.restype = ctypes.c_int
        lib.nhf_poll.argtypes = [ctypes.c_void_p, ctypes.POINTER(_NhfReq), ctypes.c_int,
                                 ctypes.c_int]
        lib.nhf_respond.restype = ctypes.c_int
        lib.nhf_respond.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                                    ctypes.c_char_p, ctypes.c_int64]
        lib.nhf_stats.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_long)]
        lib.nhf_stop.argtypes = [ctypes.c_void_p]
        lib.nhf_destroy.argtypes = [ctypes.c_void_p]
        lib.nhf_probe.restype = ctypes.c_int
        if lib.nhf_probe() != 1:
            return None
        _lib = lib
        return _lib


def available() -> bool:
    """True when the native front end is built and loadable."""
    return _load() is not None


class NativeAnomalyHTTPServer:
    """The native-transport twin of ``server.AnomalyHTTPServer``: the same
    constructor (plus ``max_queue``, the transport's shed bound, 0/None
    for none, and ``responders``, the responder pool's size), routes and
    payloads."""

    def __init__(
        self,
        scorer=None,
        meta: Optional[dict] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        score_timeout: float = 60.0,
        models: Optional[dict] = None,
        ready_timeout: float = 10.0,
        reloader: Optional[Callable[[], Tuple[dict, float]]] = None,
        max_queue: Optional[int] = 1024,
        responders: int = 16,
    ):
        lib = _load()
        if lib is None:
            raise RuntimeError("native HTTP front end unavailable (g++/build failed or "
                               "SSAD_NATIVE=0) — use serving.server.AnomalyHTTPServer")
        if models is None:
            if scorer is None or meta is None:
                raise ValueError("pass (scorer, meta) or models={name: (scorer, meta)}")
            models = {meta.get("subject") or "default": (scorer, meta)}
        self.models = dict(models)
        if meta is None and len(self.models) == 1:
            _, meta = next(iter(self.models.values()))
        self.meta = meta
        self.score_timeout = float(score_timeout)
        self.ready_timeout = float(ready_timeout)
        self.trackers = {name: ScoreTracker(baseline=m.get("calibration"))
                         for name, (_, m) in self.models.items()}
        # POST /admin/reload: serving/server.perform_reload reads these
        self.reloader = reloader
        self.reload_lock = threading.Lock()
        self._lib = lib
        # the C side reads a bound <= 0 as "its default", so no bound is
        # spelled as one no deployment reaches
        mq = int(max_queue) if max_queue else (1 << 30)
        self._handle = lib.nhf_create(host.encode(), int(port), mq, 0)
        self._poller: Optional[threading.Thread] = None
        self._pool = ThreadPoolExecutor(max_workers=responders)
        self._stopped = False
        self.port = -1

    # -- lifecycle ---------------------------------------------------------------

    def start(self) -> "NativeAnomalyHTTPServer":
        port = self._lib.nhf_start(self._handle)
        if port < 0:
            raise OSError("native front end failed to bind")
        self.port = port
        self._poller = threading.Thread(target=self._poll_loop, daemon=True)
        self._poller.start()
        return self

    def stop(self):
        if self._stopped:
            return
        self._stopped = True
        self._lib.nhf_stop(self._handle)
        if self._poller is not None:
            self._poller.join(timeout=10)
        self._pool.shutdown(wait=True)
        self._lib.nhf_destroy(self._handle)
        for sc, _ in self.models.values():
            sc.close()

    def transport_stats(self) -> dict:
        """The C++ side's counters (connections, requests, responses,
        shed_transport, protocol_errors, bytes in and out, queue depth)."""
        out = (ctypes.c_long * 8)()
        self._lib.nhf_stats(self._handle, out)
        keys = ("connections", "requests", "responses", "shed_transport",
                "protocol_errors", "bytes_in", "bytes_out", "queue_depth")
        return dict(zip(keys, [int(v) for v in out]))

    # -- request handling ----------------------------------------------------------

    def _respond(self, req_id: int, code: int, payload: dict):
        body = json.dumps(payload).encode("utf-8")
        self._lib.nhf_respond(self._handle, req_id, code, body, len(body))

    def _poll_loop(self):
        reqs = (_NhfReq * 64)()
        while True:
            n = self._lib.nhf_poll(self._handle, reqs, 64, 200)
            if n < 0:
                return
            for i in range(n):
                req_id = reqs[i].id
                try:
                    self._handle_one(reqs[i], req_id)
                except Exception as e:
                    # the one poller thread must survive any request: if
                    # it died, the C++ transport would go on accepting
                    # connections that are never answered
                    try:
                        self._respond(req_id, 500, {"error": repr(e)})
                    except Exception:
                        pass

    def _handle_one(self, req, req_id: int):
        method = req.method.decode("latin-1")
        path, _, query = req.path.decode("latin-1").partition("?")
        if method == "GET":
            if path == "/healthz":
                self._respond(req_id, 200, srv.build_healthz(self.models, self.meta))
            elif path == "/stats":
                self._respond(req_id, 200, srv.build_stats(self.models, self.trackers))
            elif path == "/metrics":
                # text/plain in the body; the C++ side writes one content
                # type, which Prometheus scrapers accept (they read the body)
                body = srv.prometheus_metrics(self.models, self.trackers).encode("utf-8")
                self._lib.nhf_respond(self._handle, req_id, 200, body, len(body))
            elif path == "/readyz":
                # the probe scores through every batcher: off the poller
                self._pool.submit(self._readyz, req_id)
            else:
                self._respond(req_id, 404, {"error": f"no route {path}"})
            return
        if method != "POST":
            self._respond(req_id, 404, {"error": f"no route {method} {path}"})
            return
        if path == "/admin/reload":
            # loading and warming take seconds: off the poller
            self._pool.submit(self._reload, req_id)
            return
        # one snapshot per request: a reload replaces the dict
        models = self.models
        if path == "/score":
            if len(models) > 1:
                self._respond(req_id, 400, {"error": "several models are loaded; POST "
                                                     "/score/<name>",
                                            "models": sorted(models)})
                return
            name = next(iter(models))
        elif path.startswith("/score/"):
            name = path[len("/score/"):]
            if name not in models:
                self._respond(req_id, 404, {"error": f"no model {name!r}",
                                            "models": sorted(models)})
                return
        else:
            self._respond(req_id, 404, {"error": f"no route {path}"})
            return
        scorer, meta = models[name]
        # copy out of the C++ buffer before a response frees it
        body = ctypes.string_at(req.body, req.body_len)
        try:
            image = srv._decode_image(body, tuple(meta["imsize"]))
        except Exception as e:  # any decode failure is the client's
            self._respond(req_id, 400, {"error": repr(e)})
            return
        try:
            try:
                pending = scorer.submit(image)
            except RuntimeError as e:
                # a reload closed this batcher between routing and
                # submit: one retry on the current model of that name
                current = self.models.get(name)
                if "scorer is closed" not in str(e) or current is None:
                    raise
                pending = current[0].submit(image)
        except srv.Overloaded as e:
            self._respond(req_id, 503, {"error": repr(e)})
            return
        except Exception as e:
            self._respond(req_id, 500, {"error": repr(e)})
            return
        self._pool.submit(self._finish, req_id, pending, name, meta,
                          srv.want_heatmap(query), time.perf_counter())

    def _readyz(self, req_id: int):
        code, payload = srv.build_readyz(self.models, self.ready_timeout)
        self._respond(req_id, code, payload)

    def _reload(self, req_id: int):
        code, payload = srv.perform_reload(self)
        self._respond(req_id, code, payload)

    def _finish(self, req_id, pending, name, meta, heatmap, t0):
        """Responder side: wait for the batch, build the payload, observe
        drift, respond."""
        try:
            if not pending.event.wait(self.score_timeout):
                self._respond(req_id, 504, {"error": "scoring timed out"})
                return
            if pending.error is not None:
                raise pending.error
            result = tuple(r[0] for r in pending.result)
            payload, observed = srv.build_score_payload(
                result, meta, heatmap, (time.perf_counter() - t0) * 1e3)
            tracker = self.trackers.get(name)  # a reload may have swapped it
            if tracker is not None:
                tracker.observe(observed)
            self._respond(req_id, 200, payload)
        except Exception as e:
            self._respond(req_id, 500, {"error": repr(e)})
