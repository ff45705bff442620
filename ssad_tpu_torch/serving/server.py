"""Serving runtime: request batching + a stdlib HTTP front end.

Counterpart of ssad_tpu/serving/server.py:52-812 but the device replicas
(``serve --devices``) and the native front end's hooks.  The scorer
runs one fixed batch shape (serving/export.py), so a launch is paid per
batch: ``BatchingScorer`` is a dynamic batcher — callers submit single
images from any thread and wait on a future; a collector thread drains
the queue until the batch fills or ``max_delay_ms`` expires, pads, runs
the scorer once and fans the rows back out.

``AnomalyHTTPServer`` puts a dependency-free HTTP API in front:

  POST /score[/<name>]  body: raw .npy (H, W, 3) — float in [0,1] or
                 uint8 (rescaled) — or any image file PIL can decode
                 (resized to the model's geometry) → JSON {score, label,
                 threshold, logits, ms}; for a patch-mode artifact
                 {map_max, map_mean, ms}, plus heatmap_b64 (a grayscale
                 PNG of the map) with ?heatmap=1
  GET  /healthz  → {"ok": true, "mode": ...} (liveness)
  GET  /readyz   → {"ready": true} or 503: a zero image actually scores
                 through every batcher (readiness)
  GET  /stats    → batcher latency/occupancy counters + the score window
                 and its drift KS against the artifact's calibration
                 (serving/drift.py)
  GET  /metrics  → the same counters in Prometheus exposition format, the
                 JAX server's families and labels (ssad_score_drift_ks,
                 ssad_score_drift_alert among them)
  POST /admin/reload → re-run the server's ``reloader`` (``cli serve``:
                 the same artifact paths, loaded and warmed) and swap the
                 models in without dropping a request: 200 with the
                 reloaded names and warm-up seconds, 404 with no
                 reloader, 409 while a reload runs, 500 with the old
                 models still serving when loading fails

The JAX server's multi-device replicas and native C++ front end are not
ported.  Scorer plumbing is callable-agnostic: anything mapping a float32
(B, H, W, 3) array to a tuple of per-row arrays serves — a ServedScorer,
or a test stub.
"""

from __future__ import annotations

import collections
import io
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

from ssad_tpu_torch.serving.drift import ScoreTracker


class Overloaded(RuntimeError):
    """The batcher's admission queue is full — shed load (HTTP 503)."""


class _Request:
    __slots__ = ("image", "event", "result", "error", "t_submit")

    def __init__(self, image: np.ndarray):
        self.image = image
        self.event = threading.Event()
        self.result: Optional[Tuple[np.ndarray, ...]] = None
        self.error: Optional[BaseException] = None
        self.t_submit = time.perf_counter()


class BatchingScorer:
    """Dynamic batcher around one fixed-batch scoring callable."""

    def __init__(
        self,
        score_fn: Callable[[np.ndarray], Sequence[np.ndarray]],
        batch: int,
        max_delay_ms: float = 5.0,
        max_queue: Optional[int] = 256,
    ):
        self._fn = score_fn
        self.batch = int(batch)
        self.max_delay = max_delay_ms / 1e3
        #: admission bound: with this many requests queued, submit()
        #: sheds load (Overloaded → HTTP 503); None disables the bound
        self.max_queue = max_queue
        self._queue: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._lock = threading.Lock()
        self._latencies = collections.deque(maxlen=1024)
        self._occupancies = collections.deque(maxlen=1024)
        self._n_requests = 0
        self._n_batches = 0
        self._closed = False
        #: how long close() waits for the collector thread
        self._join_s = 10.0
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # -- client side ---------------------------------------------------------

    def submit(self, image: np.ndarray) -> _Request:
        if self._closed:
            raise RuntimeError("scorer is closed")
        # qsize() is approximate under concurrency; the bound needs to
        # hold statistically, not exactly
        if self.max_queue is not None and self._queue.qsize() >= self.max_queue:
            raise Overloaded(f"admission queue full ({self.max_queue} pending)")
        req = _Request(np.asarray(image, dtype=np.float32))
        self._queue.put(req)
        return req

    def score(self, image: np.ndarray, timeout: float = 60.0):
        """Blocking single-image scoring: tuple of per-image results."""
        req = self.submit(image)
        if not req.event.wait(timeout):
            raise TimeoutError("scoring timed out")
        if req.error is not None:
            raise req.error
        return tuple(r[0] for r in req.result)

    def stats(self) -> dict:
        """Totals are lifetime counters; percentiles and occupancy are
        over the last ≤1024 requests/batches."""
        with self._lock:
            lat = sorted(self._latencies)
            occ = list(self._occupancies)
            n_req, n_bat = self._n_requests, self._n_batches

        def pct(p):
            return lat[min(int(p * len(lat)), len(lat) - 1)] * 1e3 if lat else None

        return {
            "requests": n_req,
            "batches": n_bat,
            "mean_batch_occupancy": float(np.mean(occ)) if occ else None,
            "latency_ms_p50": pct(0.50),
            "latency_ms_p95": pct(0.95),
            "queue_depth": self._queue.qsize(),
            "max_queue": self.max_queue,
        }

    def close(self):
        if self._closed:
            return
        self._closed = True
        self._queue.put(None)
        self._thread.join(timeout=self._join_s)
        if self._thread.is_alive():
            # the collector is inside a long scorer call and has not seen
            # the sentinel yet; it cancels what is pending when it does
            return
        # requests that raced past the _closed check may sit behind the
        # sentinel — fail them now instead of at their timeout
        self._cancel_pending()

    def _cancel_pending(self):
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                return
            if req is not None:
                req.error = RuntimeError("scorer is closed")
                req.event.set()

    # -- collector thread ----------------------------------------------------

    def _loop(self):
        while True:
            req = self._queue.get()
            if req is None:
                self._cancel_pending()
                return
            reqs = [req]
            deadline = time.perf_counter() + self.max_delay
            while len(reqs) < self.batch:
                budget = deadline - time.perf_counter()
                if budget <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=budget)
                except queue.Empty:
                    break
                if nxt is None:
                    self._run(reqs)
                    self._cancel_pending()
                    return
                reqs.append(nxt)
            self._run(reqs)

    def _run(self, reqs):
        n = len(reqs)
        try:
            x = np.stack([r.image for r in reqs])
            if n < self.batch:
                x = np.pad(x, ((0, self.batch - n),) + ((0, 0),) * 3)
            results = tuple(np.asarray(r) for r in self._fn(x))
            now = time.perf_counter()
            with self._lock:
                self._occupancies.append(n / self.batch)
                self._latencies.extend(now - r.t_submit for r in reqs)
                self._n_batches += 1
                self._n_requests += n
            for i, r in enumerate(reqs):
                r.result = tuple(res[i : i + 1] for res in results)
                r.event.set()
        except Exception as e:  # the collector must keep running: fail the batch
            for r in reqs:
                r.error = e
                r.event.set()


# -- HTTP front end ----------------------------------------------------------


def _decode_image(body: bytes, imsize: Tuple[int, int]) -> np.ndarray:
    """Request body → (H, W, 3) float32 in [0,1], validated before the
    request enters the batcher (a wrong-shaped row would fail the whole
    batch).  Encoded images go through data/mvtec.load_image, the decode
    the evaluation pipeline uses."""
    if body[:6] == b"\x93NUMPY":
        return coerce_image_array(np.load(io.BytesIO(body)), imsize)
    from ssad_tpu_torch.data.mvtec import load_image

    return load_image(io.BytesIO(body), imsize)


def coerce_image_array(arr: np.ndarray, imsize: Tuple[int, int]) -> np.ndarray:
    """Validate/convert a raw array to the (H, W, 3) float32 [0,1]
    contract: uint8 is rescaled; floats outside [0,1] are rejected rather
    than scored against a threshold calibrated on [0,1] data."""
    if arr.shape != (imsize[0], imsize[1], 3):
        raise ValueError(
            f"npy body must be ({imsize[0]}, {imsize[1]}, 3) to match "
            f"the model geometry, got {arr.shape}"
        )
    if arr.dtype == np.uint8:
        return arr.astype(np.float32) / 255.0
    if not np.issubdtype(arr.dtype, np.floating):
        raise ValueError(f"npy dtype must be float or uint8, got {arr.dtype}")
    arr = arr.astype(np.float32)
    lo, hi = (float(arr.min()), float(arr.max())) if arr.size else (0.0, 0.0)
    if lo < -1e-3 or hi > 1.0 + 1e-3:
        raise ValueError(
            f"float npy values must be in [0, 1] (got range [{lo:.3g}, "
            f"{hi:.3g}]); scale before posting"
        )
    return arr


def prometheus_metrics(models: dict, trackers: Optional[dict] = None) -> str:
    """Every model's batcher counters (and with ``trackers`` its score
    window and drift KS) in the Prometheus text format, one ``model``
    label per series; each family one uninterrupted group, HELP and TYPE
    first, as strict parsers require."""
    stats = {name: sc.stats() for name, (sc, _) in sorted(models.items())}
    for name, st in stats.items():
        # .get: a reload swaps models and trackers as two assignments; a
        # scrape between them loses the score families, not the scrape
        tracker = (trackers or {}).get(name)
        if tracker is not None:
            st.update(("score_" + k, v) for k, v in tracker.stats().items())

    def quantiles(pairs):
        return lambda st, name: [(f'{{model="{name}",quantile="{q}"}}', f"{st[key]:.6f}")
                                 for q, key in pairs if st.get(key) is not None]

    families = (
        ("ssad_requests_total", "counter", "Scored requests since start.",
         lambda st, name: [(f'{{model="{name}"}}', st["requests"])]),
        ("ssad_batches_total", "counter", "Executed scoring batches since start.",
         lambda st, name: [(f'{{model="{name}"}}', st["batches"])]),
        ("ssad_replica_batches_total", "counter",
         "Batches executed per device replica (serve --devices).",
         lambda st, name: [(f'{{model="{name}",replica="{i}"}}', v)
                           for i, v in enumerate(st.get("replica_batches") or [])]),
        ("ssad_queue_depth", "gauge", "Requests waiting for admission right now.",
         lambda st, name: [(f'{{model="{name}"}}', st["queue_depth"])]),
        ("ssad_batch_occupancy_mean", "gauge", "Mean filled fraction of recent batches.",
         lambda st, name: [] if st["mean_batch_occupancy"] is None else
         [(f'{{model="{name}"}}', f"{st['mean_batch_occupancy']:.6f}")]),
        ("ssad_request_latency_ms", "summary",
         "Client-to-result latency quantiles over recent requests.",
         quantiles((("0.5", "latency_ms_p50"), ("0.95", "latency_ms_p95")))),
        ("ssad_recent_score", "summary",
         "Anomaly-score quantiles over the recent request window.",
         quantiles((("0.5", "score_recent_p50"), ("0.95", "score_recent_p95")))),
        ("ssad_score_drift_ks", "gauge",
         "KS distance of recent scores vs the artifact's calibration "
         "distribution (serving/drift.py).",
         lambda st, name: [] if st.get("score_drift_ks") is None else
         [(f'{{model="{name}"}}', f"{st['score_drift_ks']:.6f}")]),
        ("ssad_score_drift_alert", "gauge",
         "1 when the drift KS exceeds the alpha=0.05 critical value.",
         lambda st, name: [] if st.get("score_drift_alert") is None else
         [(f'{{model="{name}"}}', int(st["score_drift_alert"]))]),
    )
    lines = []
    for family, kind, help_text, samples in families:
        lines += [f"# HELP {family} {help_text}", f"# TYPE {family} {kind}"]
        for name, st in stats.items():
            lines += [f"{family}{labels} {value}" for labels, value in samples(st, name)]
    return "\n".join(lines) + "\n"


def perform_reload(server) -> Tuple[int, dict]:
    """POST /admin/reload → (status, payload).  The reloader builds and
    warms the new batchers first; the ``models`` and ``trackers`` dicts
    are then replaced (one assignment each) and only then the old
    batchers closed.  ``BatchingScorer.close`` runs every request already
    queued before it stops, so requests in flight finish on the old
    models; one that fetched the old batcher and submits after its close
    is retried once on the new ones (``score_with_reload_retry``).  404
    with no reloader, 409 while another reload runs, 500 with the old
    models still serving when the reloader raises."""
    reloader = server.reloader
    if reloader is None:
        return 404, {"error": "no reloader configured (start the server via `cli serve` "
                              "to enable /admin/reload)"}
    if not server.reload_lock.acquire(blocking=False):
        return 409, {"error": "a reload is already in progress"}
    try:
        t0 = time.perf_counter()
        try:
            new_models, warmup_s = reloader()
        except Exception as e:  # the old models keep serving
            return 500, {"error": f"reload failed; previous models still serving: {e!r}"}
        old = server.models
        server.trackers = {name: ScoreTracker(baseline=m.get("calibration"))
                           for name, (_, m) in new_models.items()}
        server.models = dict(new_models)
        if len(new_models) == 1:
            _, server.meta = next(iter(new_models.values()))
        for sc, _ in old.values():
            sc.close()
        return 200, {"reloaded": sorted(new_models), "warmup_s": round(warmup_s, 2),
                     "total_s": round(time.perf_counter() - t0, 2)}
    finally:
        server.reload_lock.release()


def score_with_reload_retry(server, name: str, scorer: BatchingScorer, image, timeout: float):
    """``scorer.score``, retried once on the server's current model of that
    name when a reload closed the batcher this request had fetched."""
    try:
        return scorer.score(image, timeout=timeout)
    except RuntimeError as e:
        if "scorer is closed" not in str(e):
            raise
        current = server.models.get(name)
        if current is None:
            raise
        return current[0].score(image, timeout=timeout)


def build_healthz(models: dict, meta: Optional[dict]) -> dict:
    if len(models) > 1:
        return {"ok": True, "models": {name: m.get("mode") for name, (_, m) in models.items()}}
    return {"ok": True, "mode": (meta or {}).get("mode")}


def build_readyz(models: dict, ready_timeout: float) -> Tuple[int, dict]:
    failures = {}
    for name, (sc, m) in models.items():
        try:
            h, w = m["imsize"]
            sc.score(np.zeros((h, w, 3), np.float32), timeout=ready_timeout)
        except Exception as e:  # a probe reports every failure, it does not raise
            failures[name] = repr(e)
    if failures:
        return 503, {"ready": False, "failures": failures}
    return 200, {"ready": True}


def build_stats(models: dict, trackers: dict) -> dict:
    def scores(name: str) -> dict:
        # .get: a reload may land between the reads of models and trackers
        tracker = trackers.get(name)
        return tracker.stats() if tracker is not None else {}

    if len(models) > 1:
        return {name: {**sc.stats(), "scores": scores(name)} for name, (sc, _) in models.items()}
    name, (sc, _) = next(iter(models.items()))
    return {**sc.stats(), "scores": scores(name)}


def heatmap_to_uint8(amap: np.ndarray) -> np.ndarray:
    """Min-max normalise an anomaly map to a uint8 grayscale image: the one
    rendering shared by ``?heatmap=1`` and ``cli score --heatmaps``."""
    lo, hi = float(amap.min()), float(amap.max())
    norm = (amap - lo) / (hi - lo + 1e-12)
    return (norm * 255).astype(np.uint8)


def _heatmap_png_b64(amap: np.ndarray) -> str:
    import base64

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(heatmap_to_uint8(amap)).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode("ascii")


def want_heatmap(query: str) -> bool:
    from urllib.parse import parse_qs

    return parse_qs(query).get("heatmap", ["0"])[0] == "1"


def build_score_payload(result, meta: dict, want_heatmap: bool, ms: float) -> Tuple[dict, float]:
    """(response payload, the scalar the drift tracker observes)."""
    if meta.get("mode") == "patch":
        amap = np.asarray(result[0])
        payload = {
            "map_max": float(amap.max()),
            "map_mean": float(amap.mean()),
            "ms": round(ms, 3),
        }
        if want_heatmap:
            payload["heatmap_b64"] = _heatmap_png_b64(amap)
        return payload, payload["map_max"]
    score, label = result[0], result[1]
    payload = {
        "score": float(score),
        "label": int(label),
        "threshold": meta.get("threshold"),
        "ms": round(ms, 3),
    }
    if len(result) > 2:
        payload["logits"] = np.asarray(result[2]).tolist()
    return payload, payload["score"]


class AnomalyHTTPServer:
    """Bind one or many BatchingScorers to an HTTP port (``port=0``
    picks a free one; read it back from ``.port``).

    ``AnomalyHTTPServer(scorer, meta)`` routes ``POST /score``;
    ``models={name: (scorer, meta)}`` adds ``POST /score/<name>``, and
    ``/score`` keeps working while exactly one model is loaded.
    ``reloader``, () → ({name: (scorer, meta)}, warm-up seconds), enables
    ``POST /admin/reload``.
    """

    def __init__(
        self,
        scorer: Optional[BatchingScorer] = None,
        meta: Optional[dict] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        score_timeout: float = 60.0,
        models: Optional[dict] = None,
        ready_timeout: float = 10.0,
        reloader: Optional[Callable[[], Tuple[dict, float]]] = None,
    ):
        if models is None:
            if scorer is None or meta is None:
                raise ValueError("pass (scorer, meta) or models={name: (scorer, meta)}")
            models = {meta.get("subject") or "default": (scorer, meta)}
        self.reloader = reloader
        self.reload_lock = threading.Lock()
        self.models = dict(models)
        if meta is None and len(self.models) == 1:
            _, meta = next(iter(self.models.values()))
        self.meta = meta
        self.score_timeout = float(score_timeout)
        self.ready_timeout = float(ready_timeout)
        self.trackers = {
            name: ScoreTracker(baseline=m.get("calibration"))
            for name, (_, m) in self.models.items()
        }
        outer = self

        class Handler(BaseHTTPRequestHandler):
            # keep-alive: every response path sends Content-Length
            protocol_version = "HTTP/1.1"
            # without TCP_NODELAY the body segment waits for the client's
            # delayed ACK of the header segment (~40 ms per response)
            disable_nagle_algorithm = True

            def log_message(self, *args):  # quiet
                pass

            def _json(self, code: int, payload: dict):
                body = json.dumps(payload).encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                if self.close_connection:
                    self.send_header("Connection", "close")
                self.end_headers()
                self.wfile.write(body)

            def _text(self, code: int, text: str, ctype: str):
                body = text.encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.partition("?")[0]
                if path == "/metrics":
                    self._text(200, prometheus_metrics(outer.models, outer.trackers),
                               "text/plain; version=0.0.4")
                elif path == "/readyz":
                    self._json(*build_readyz(outer.models, outer.ready_timeout))
                elif path == "/healthz":
                    self._json(200, build_healthz(outer.models, outer.meta))
                elif path == "/stats":
                    self._json(200, build_stats(outer.models, outer.trackers))
                else:
                    self._json(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                path, _, query = self.path.partition("?")
                # Content-Length framing only: an undrained chunked body
                # would desync the keep-alive socket — reject and close
                if "chunked" in (self.headers.get("Transfer-Encoding") or "").lower():
                    self.close_connection = True
                    self._json(411, {"error": "chunked bodies are not supported; "
                                              "send Content-Length"})
                    return
                # drain the body before any (error) response
                body = self.rfile.read(int(self.headers.get("Content-Length", "0")))
                if path == "/admin/reload":
                    # synchronous: answers once the new models are loaded,
                    # warmed and swapped in and the old batchers drained
                    self._json(*perform_reload(outer))
                    return
                # one snapshot per request: a reload replaces both dicts
                models, trackers = outer.models, outer.trackers
                if path == "/score":
                    if len(models) > 1:
                        self._json(400, {"error": "several models are loaded; POST "
                                                  "/score/<name>",
                                         "models": sorted(models)})
                        return
                    name = next(iter(models))
                elif path.startswith("/score/"):
                    name = path[len("/score/"):]
                    if name not in models:
                        self._json(404, {"error": f"no model {name!r}",
                                         "models": sorted(models)})
                        return
                else:
                    self._json(404, {"error": f"no route {path}"})
                    return
                scorer, meta = models[name]
                # bad body → 400; queue full → 503; timeout → 504;
                # scorer fault → 500
                try:
                    image = _decode_image(body, tuple(meta["imsize"]))
                except Exception as e:  # any decode failure is the client's
                    self._json(400, {"error": repr(e)})
                    return
                try:
                    t0 = time.perf_counter()
                    result = score_with_reload_retry(outer, name, scorer, image,
                                                     outer.score_timeout)
                    payload, observed = build_score_payload(
                        result, meta, want_heatmap(query), (time.perf_counter() - t0) * 1e3
                    )
                    tracker = trackers.get(name)
                    if tracker is not None:
                        tracker.observe(observed)
                    self._json(200, payload)
                except Overloaded as e:
                    self._json(503, {"error": repr(e)})
                except TimeoutError as e:
                    self._json(504, {"error": repr(e)})
                except Exception as e:  # the server keeps serving; the client sees 500
                    self._json(500, {"error": repr(e)})

        class Server(ThreadingHTTPServer):
            # the stdlib backlog (5) resets connections under bursts
            request_queue_size = 128
            daemon_threads = True

        self._httpd = Server((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)

    def start(self) -> "AnomalyHTTPServer":
        self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        for sc, _ in self.models.values():
            sc.close()
