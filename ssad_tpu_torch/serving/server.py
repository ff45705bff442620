"""Serving runtime: request batching + a stdlib HTTP front end.

Counterpart of ssad_tpu/serving/server.py:52-812.  The scorer runs one
fixed batch shape (serving/export.py), so a launch is paid per batch:
``BatchingScorer`` is a dynamic batcher — callers submit single images
from any thread and wait on a future; a collector thread drains the
queue until the batch fills or ``max_delay_ms`` expires, stages it in a
reused, zero-padded buffer (page-locked where there is a CUDA device),
runs the scorer once and fans the rows back out.  Over a list of
scorers (one per device replica, ``serve --devices``;
serving/replicas.py) it runs one runner thread per scorer, so several
batches are in flight at once.

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

The route semantics live in the ``build_*`` helpers below, shared with
the native C++ front end (serving/native_frontend.py, ``serve
--frontend native``).  Scorer plumbing is callable-agnostic: anything mapping a float32
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
from ssad_tpu_torch.utils.profiling import span


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
    """Dynamic batcher around one or many fixed-batch scoring callables.

    ``score_fn`` is one callable or a list of them (one per device
    replica, serving/replicas.py).  One collector thread assembles every
    batch, so the batching policy stays in one place; with several
    callables it hands each batch to a run queue bounded at the runner
    count, drained by one runner thread per callable, so up to that many
    batches run at once.  When every runner is busy and one batch is
    staged per runner, assembly blocks and admission pressure surfaces
    at ``max_queue`` as with one callable.

    ``warmup``, callable → seconds, runs once per callable on the thread
    that will run that callable (the collector, or its runner) before
    the constructor returns; PyTorch creates cuDNN/cuBLAS handles per
    thread, so a warm-up on any other thread would leave that first cost
    to the first request.  It counts no request or batch; ``warmup_s``
    is the sum of what it returned, and a warm-up that raises closes
    the batcher and raises from the constructor.

    Each runner (the collector, with one callable) assembles its batches
    in a staging buffer of its own, ``(batch,) + row shape``, reused from
    batch to batch: the rows are copied into its first rows and the rows
    after them are zero, as a padded ``np.stack`` would give, and the
    callable receives the whole buffer.  A callable that describes its
    input as an artifact does (``meta["imsize"]``: ``ServedScorer``,
    ``DeviceReplica``) gets the buffer at warm-up; any other on its
    first batch, and a batch of another row shape gets a new one.  The
    buffer is page-locked where the callable's ``device`` is a CUDA
    device (or, for a callable that names no device, where the process
    sees one), so a scorer's ``torch.from_numpy(x).to(device)`` is a
    direct DMA, not a copy staged through CUDA's own bounce buffer; a
    CPU scorer gets plain numpy memory and creates no CUDA context.  A
    callable must be done with its input when it returns
    (``ServedScorer``'s upload is synchronous); results that share
    memory with the buffer are copied before they are handed out.

    Under ``torch.profiler`` (utils/profiling.span) the collector's loop
    is tiled by ``ssad.batcher.collect`` (waiting for a batch's first
    request until the batch closes), and each batch's thread by
    ``ssad.batcher.stack`` (the copy into the staging buffer),
    ``ssad.batcher.run`` (the scoring callable) and
    ``ssad.batcher.fanout`` (rows back to the requests, counters).
    """

    def __init__(
        self,
        score_fn: Callable[[np.ndarray], Sequence[np.ndarray]] | Sequence[Callable],
        batch: int,
        max_delay_ms: float = 5.0,
        max_queue: Optional[int] = 256,
        warmup: Optional[Callable[[Callable], float]] = None,
    ):
        fns = list(score_fn) if isinstance(score_fn, (list, tuple)) else [score_fn]
        if not fns:
            raise ValueError("need at least one scoring callable")
        self._fns = fns
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
        self._queue_wait_s = 0.0
        self._latency_s = 0.0
        self._runner_batches = [0] * len(fns)
        #: one per runner, touched only by that runner's thread
        self._staging = [_Staging(self.batch, _pins(fn)) for fn in fns]
        self._closed = False
        #: how long close() waits for the collector and each runner
        self._join_s = 10.0
        self._warmup = warmup
        self._warmed = [(threading.Event(), [0.0, None]) for _ in fns]
        self._run_queue: Optional[queue.Queue] = None
        self._runners = []
        if len(fns) > 1:
            self._run_queue = queue.Queue(maxsize=len(fns))
            self._runners = [threading.Thread(target=self._runner_loop, args=(i,), daemon=True)
                             for i in range(len(fns))]
            for t in self._runners:
                t.start()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        for done, _ in self._warmed:
            done.wait()
        errors = [err for _, (_, err) in self._warmed if err is not None]
        if errors:
            self.close()
            raise errors[0]
        self.warmup_s = sum(secs for _, (secs, _) in self._warmed)

    def _warm_this_thread(self, idx: int):
        done, result = self._warmed[idx]
        try:
            if self._warmup is not None:
                result[0] = float(self._warmup(self._fns[idx]))
            imsize = (getattr(self._fns[idx], "meta", None) or {}).get("imsize")
            if imsize is not None:
                self._staging[idx].reserve(tuple(imsize) + (3,))
        except Exception as e:  # re-raised by the constructor
            result[1] = e
        finally:
            done.set()

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
        over the last ≤1024 requests/batches.  ``queue_wait_s_total``
        (submit → its batch's scorer call) and ``latency_s_total``
        (submit → answer) are summed over the answered requests, so the
        mean over any window is the difference of two reads over the
        difference of ``requests``.  With several callables also
        ``replicas`` and ``replica_batches`` (batches per runner)."""
        with self._lock:
            lat = sorted(self._latencies)
            occ = list(self._occupancies)
            n_req, n_bat = self._n_requests, self._n_batches
            wait_s, latency_s = self._queue_wait_s, self._latency_s
            per_runner = list(self._runner_batches)

        def pct(p):
            return lat[min(int(p * len(lat)), len(lat) - 1)] * 1e3 if lat else None

        out = {
            "requests": n_req,
            "batches": n_bat,
            "queue_wait_s_total": wait_s,
            "latency_s_total": latency_s,
            "mean_batch_occupancy": float(np.mean(occ)) if occ else None,
            "latency_ms_p50": pct(0.50),
            "latency_ms_p95": pct(0.95),
            "queue_depth": self._queue.qsize(),
            "max_queue": self.max_queue,
        }
        if len(self._fns) > 1:
            out["replicas"] = len(self._fns)
            out["replica_batches"] = per_runner
        return out

    def close(self):
        if self._closed:
            return
        self._closed = True
        self._queue.put(None)
        self._thread.join(timeout=self._join_s)
        if self._thread.is_alive():
            # the collector is inside a long scorer call and has not seen
            # the sentinel yet: draining the queue here could eat it and
            # strand the collector and every runner.  When it unblocks it
            # consumes the sentinel, stops the runners and cancels what
            # is pending itself (_loop)
            return
        for t in self._runners:
            t.join(timeout=self._join_s)
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
        if self._run_queue is None:
            self._warm_this_thread(0)
        while True:
            with span("ssad.batcher.collect"):
                reqs, closing = self._collect()
            if reqs:
                self._dispatch(reqs)
            if closing:
                self._stop_runners()
                self._cancel_pending()
                return

    def _collect(self):
        """(the next batch's requests, whether the sentinel came): the
        first request, then more until the batch is full or
        ``max_delay_ms`` has passed since the first."""
        req = self._queue.get()
        if req is None:
            return [], True
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
                return reqs, True
            reqs.append(nxt)
        return reqs, False

    def _dispatch(self, reqs):
        if self._run_queue is None:
            self._run(reqs, 0)
        else:
            # blocks while every runner is busy and one batch is staged
            # per runner: backpressure reaches max_queue
            self._run_queue.put(reqs)

    def _stop_runners(self):
        # runners drain FIFO: every staged batch runs before its runner
        # sees the sentinel
        for _ in self._runners:
            self._run_queue.put(None)

    # -- runner threads (several callables) ------------------------------------

    def _runner_loop(self, idx: int):
        self._warm_this_thread(idx)
        while True:
            reqs = self._run_queue.get()
            if reqs is None:
                return
            self._run(reqs, idx)

    def _run(self, reqs, idx: int):
        n = len(reqs)
        try:
            with span("ssad.batcher.stack"):
                x = self._staging[idx].stage([r.image for r in reqs])
            with span("ssad.batcher.run"):
                start = time.perf_counter()
                results = tuple(np.asarray(r) for r in self._fns[idx](x))
            with span("ssad.batcher.fanout"):
                # the next batch overwrites the buffer: an answer must
                # not be a view of it
                results = tuple(r.copy() if np.may_share_memory(r, x) else r for r in results)
                now = time.perf_counter()
                latencies = [now - r.t_submit for r in reqs]
                with self._lock:
                    self._occupancies.append(n / self.batch)
                    self._latencies.extend(latencies)
                    self._queue_wait_s += sum(start - r.t_submit for r in reqs)
                    self._latency_s += sum(latencies)
                    self._n_batches += 1
                    self._n_requests += n
                    self._runner_batches[idx] += 1
                for i, r in enumerate(reqs):
                    r.result = tuple(res[i : i + 1] for res in results)
                    r.event.set()
        except Exception as e:  # the thread must keep running: fail this batch only
            for r in reqs:
                r.error = e
                r.event.set()


class _Staging:
    """One runner's staging buffer: ``stage`` copies a batch's rows into
    its first rows and leaves the rest zero.  ``dirty`` is the high-water
    mark of rows that may hold an earlier batch's data, so a short batch
    zeroes only those and a full one nothing."""

    def __init__(self, batch: int, pinned: bool):
        self.batch = batch
        self.pinned = pinned
        self.buf: Optional[np.ndarray] = None
        self.dirty = 0

    def reserve(self, row_shape: Tuple[int, ...]) -> np.ndarray:
        """The buffer for rows of ``row_shape``, zeroed and new unless the
        one held already has it."""
        if self.buf is None or self.buf.shape[1:] != row_shape:
            self.buf = _host_buffer((self.batch,) + row_shape, self.pinned)
            self.dirty = 0
        return self.buf

    def stage(self, images: Sequence[np.ndarray]) -> np.ndarray:
        """The batch, zero-padded, in the buffer; rows of differing shapes
        raise ``np.stack``'s ValueError before any row is written."""
        buf, n = self.reserve(images[0].shape), len(images)
        np.stack(images, out=buf[:n])
        if self.dirty > n:
            buf[n:self.dirty] = 0
        self.dirty = n
        return buf


def _pins(fn) -> bool:
    """Whether ``fn``'s staging buffer is page-locked: where its
    ``device`` is a CUDA device, or, where it names none, where the
    process sees one."""
    import torch

    device = getattr(fn, "device", None)
    if device is None:
        return torch.cuda.is_available()
    return torch.device(device).type == "cuda"


def _host_buffer(shape: Tuple[int, ...], pinned: bool) -> np.ndarray:
    """Zeroed float32 host memory (``submit`` makes every row float32),
    page-locked where ``pinned`` (the copy to any device then runs at the
    DMA engine's rate, and under unified addressing every device sees it
    pinned)."""
    if not pinned:
        return np.zeros(shape, np.float32)
    import torch

    return torch.zeros(shape, dtype=torch.float32, pin_memory=True).numpy()


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
