"""Closed- and open-loop HTTP load generator for the serving stack.

Counterpart of ssad_tpu/serving/loadgen.py (a copy: it is stdlib and
numpy only).  It answers what the batcher's own counters cannot: the
throughput and client-observed latency the WHOLE stack (HTTP front end →
admission queue → dynamic batcher → scorer on the card → JSON response)
sustains at a given concurrency, and where it starts shedding.

Closed-loop: each worker thread keeps exactly one request in flight, so
the offered load adapts to the service rate and the measured qps is the
stack's capacity at that concurrency.  Workers hold keep-alive
connections; a connection that drops is reopened once per request.
Client and server share the host's cores in process
(``cli serve-bench --artifact``): the numbers price the full stack,
client included; ``--url`` from another host removes the client share.
"""

from __future__ import annotations

import http.client
import io
import json
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np


def npy_body(imsize: Tuple[int, int], seed: int = 0) -> bytes:
    """A random (H, W, 3) float32 image serialized as .npy — the
    zero-decode-cost request body (server-side: np.load, no PIL)."""
    rng = np.random.default_rng(seed)
    img = rng.random((imsize[0], imsize[1], 3), dtype=np.float32)
    buf = io.BytesIO()
    np.save(buf, img)
    return buf.getvalue()


def _percentile(sorted_ms: List[float], p: float) -> float:
    return sorted_ms[min(int(p * len(sorted_ms)), len(sorted_ms) - 1)]


def run_load(
    host: str,
    port: int,
    body: bytes,
    path: str = "/score",
    concurrency: int = 4,
    total: int = 100,
    timeout: float = 120.0,
    rate: Optional[float] = None,
) -> Dict:
    """Fire `total` POSTs at `path`; returns {"ok", "shed", "errors",
    "codes", "wall_s", "qps", "latency_ms": {mean, p50, p95, p99, max}}.

    Two modes:
    * closed-loop (rate=None): each worker keeps one request in
      flight — measured qps IS the stack's capacity at that
      concurrency (the capacity question).
    * open-loop (rate=R requests/sec): request i is SCHEDULED at
      t0 + i/R regardless of how the server is doing, and its latency
      is measured from the scheduled arrival — so a stalled server
      accrues queueing delay instead of silently slowing the offered
      load (the coordinated-omission trap).  This answers the SLO
      question: "at R qps offered, what latency do clients see?"
      `concurrency` caps in-flight requests; if the schedule outruns
      the workers, the backlog shows up as latency, as it should.

    "shed" counts HTTP 503 (the batcher's admission bound doing its
    job); "errors" is every other non-200 plus transport failures.
    qps counts successful scores only — a shed request costs the server
    almost nothing and must not inflate throughput.
    """
    lock = threading.Lock()
    next_i = [0]
    latencies: List[float] = []
    codes: Dict[str, int] = {}
    headers = {"Content-Type": "application/octet-stream"}
    start = time.perf_counter() + 0.02

    def take() -> Optional[int]:
        with lock:
            if next_i[0] >= total:
                return None
            next_i[0] += 1
            return next_i[0] - 1

    def record(code: str, dt_ms: Optional[float]) -> None:
        with lock:
            codes[code] = codes.get(code, 0) + 1
            if dt_ms is not None:
                latencies.append(dt_ms)

    def worker() -> None:
        conn = http.client.HTTPConnection(host, port, timeout=timeout)
        while (i := take()) is not None:
            if rate:
                t0 = start + i / rate
                delay = t0 - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
            else:
                t0 = time.perf_counter()
            try:
                conn.request("POST", path, body=body, headers=headers)
                resp = conn.getresponse()
                resp.read()
                code = resp.status
            except Exception:
                # one reopen per request: keep-alive sockets can die
                # under load (server restarts a worker, idle timeout)
                conn.close()
                conn = http.client.HTTPConnection(host, port, timeout=timeout)
                try:
                    conn.request("POST", path, body=body, headers=headers)
                    resp = conn.getresponse()
                    resp.read()
                    code = resp.status
                except Exception as e:
                    record(f"transport:{type(e).__name__}", None)
                    continue
            dt = (time.perf_counter() - t0) * 1e3
            record(str(code), dt if code == 200 else None)
        conn.close()

    threads = [threading.Thread(target=worker) for _ in range(concurrency)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0

    ok = codes.get("200", 0)
    shed = codes.get("503", 0)
    errors = sum(v for k, v in codes.items() if k not in ("200", "503"))
    lat = sorted(latencies)
    return {
        "requests": total,
        "concurrency": concurrency,
        "offered_rate": rate,
        "ok": ok,
        "shed": shed,
        "errors": errors,
        "codes": codes,
        "wall_s": round(wall, 3),
        "qps": round(ok / wall, 2) if wall > 0 else None,
        "latency_ms": {
            "mean": round(float(np.mean(lat)), 3),
            "p50": round(_percentile(lat, 0.50), 3),
            "p95": round(_percentile(lat, 0.95), 3),
            "p99": round(_percentile(lat, 0.99), 3),
            "max": round(lat[-1], 3),
        }
        if lat
        else None,
    }


def fetch_stats(host: str, port: int, timeout: float = 10.0) -> Optional[Dict]:
    """GET /stats — the server-side batcher counters (occupancy is the
    number that explains qps: half-empty batches waste the program)."""
    try:
        conn = http.client.HTTPConnection(host, port, timeout=timeout)
        conn.request("GET", "/stats")
        resp = conn.getresponse()
        payload = json.loads(resp.read().decode("utf-8"))
        conn.close()
        return payload if resp.status == 200 else None
    except Exception:
        return None
