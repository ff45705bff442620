"""Python client for the serving HTTP API (serving/server.py).

Counterpart of ssad_tpu/serving/client.py (a copy: it is stdlib only):
``http.client`` with one keep-alive connection per thread, npy encoding
of arrays, optional retry with backoff on load-shed 503s, heatmap
decoding, and an exception per status class, so callers can tell "back
off" (``Overloaded``) from "fix the request" (``BadRequest``).

    from ssad_tpu_torch.serving.client import ServingClient

    client = ServingClient("http://gpu-host:8000", model="bottle")
    out = client.score(image)            # (H, W, 3) float [0,1] / uint8
    out = client.score_file("shot.png")  # server-side decode+resize
    client.stats()["scores"]["drift_ks"]
"""

from __future__ import annotations

import http.client
import io
import json
import threading
import time
import urllib.parse
from pathlib import Path
from typing import Optional

import numpy as np


class ServingError(RuntimeError):
    """Base: any non-2xx response.  `.status` and `.payload` (parsed
    JSON body when the server sent one) carry the details."""

    def __init__(self, status: int, payload):
        self.status = status
        self.payload = payload
        detail = payload.get("error") if isinstance(payload, dict) else payload
        super().__init__(f"HTTP {status}: {detail}")


class BadRequest(ServingError):
    """400 — the request body/geometry/scale is wrong; fix the input."""


class NoSuchRoute(ServingError):
    """404 — unknown route or model name."""


class Overloaded(ServingError):
    """503 — the admission queue shed the request; retry with backoff
    (or let `retries=` do it)."""


class ScoreTimeout(ServingError):
    """504 — scoring exceeded the server's --score-timeout."""


class ServerFault(ServingError):
    """5xx other than 503/504 — an internal scorer fault."""


def _error_for(status: int, payload) -> ServingError:
    cls = {
        400: BadRequest, 404: NoSuchRoute, 503: Overloaded, 504: ScoreTimeout,
    }.get(status, ServerFault if status >= 500 else ServingError)
    return cls(status, payload)


class ServingClient:
    """One scoring endpoint.  Thread-safe: each thread gets its own
    persistent keep-alive connection (http.client connections are not
    shareable across threads mid-request).

    `model` routes to ``POST /score/<model>`` on a multi-model server;
    None uses the bare ``/score`` (valid while exactly one model is
    loaded).  `retries` re-submits on 503 load shedding with
    exponential backoff — bounded, so a saturated server still
    surfaces as `Overloaded` rather than hanging the caller."""

    def __init__(
        self,
        url: str,
        model: Optional[str] = None,
        timeout: float = 60.0,
        retries: int = 0,
        backoff_s: float = 0.1,
    ):
        parsed = urllib.parse.urlparse(url if "//" in url else "http://" + url)
        if parsed.scheme != "http":
            raise ValueError(f"only http:// endpoints are supported, got {url!r}")
        self.host = parsed.hostname or "127.0.0.1"
        self.port = parsed.port or 80
        self.model = model
        self.timeout = float(timeout)
        self.retries = int(retries)
        self.backoff_s = float(backoff_s)
        self._local = threading.local()

    # -- transport -------------------------------------------------------

    def _connection(self) -> http.client.HTTPConnection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = http.client.HTTPConnection(
                self.host, self.port, timeout=self.timeout
            )
            self._local.conn = conn
        return conn

    def _request(self, method: str, path: str, body: Optional[bytes] = None):
        """(status, body bytes) with one transparent reconnect: a
        keep-alive connection the server closed between requests
        surfaces as a broken pipe / reset / BadStatusLine on the NEXT
        use.  Timeouts are NOT retried — a timed-out POST may have
        reached the server (re-sending /score double-scores the image
        and double-counts drift; re-sending /admin/reload races the
        caller's own in-flight reload into a spurious 409)."""
        for attempt in (0, 1):
            conn = self._connection()
            try:
                conn.request(method, path, body=body)
                resp = conn.getresponse()
                return resp.status, resp.read()
            except TimeoutError:
                conn.close()
                self._local.conn = None
                raise
            except (http.client.HTTPException, ConnectionError):
                conn.close()
                self._local.conn = None
                if attempt:
                    raise
        raise AssertionError("unreachable")

    def _json(self, method: str, path: str, body: Optional[bytes] = None) -> dict:
        status, raw = self._request(method, path, body)
        try:
            payload = json.loads(raw.decode("utf-8"))
        except Exception:
            payload = raw.decode("utf-8", "replace")
        if status >= 400:
            raise _error_for(status, payload)
        return payload

    def close(self) -> None:
        """Close the CALLING thread's connection (other threads' close
        when they are garbage collected or close() themselves)."""
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.close()
            self._local.conn = None

    def __enter__(self) -> "ServingClient":
        return self

    def __exit__(self, *_) -> None:
        self.close()

    # -- scoring ---------------------------------------------------------

    @property
    def _score_path(self) -> str:
        return f"/score/{self.model}" if self.model else "/score"

    def score_bytes(self, body: bytes, heatmap: bool = False) -> dict:
        """POST a raw request body (npy bytes, or any PIL-decodable
        image file's bytes — the server decodes and resizes).  Returns
        the response dict; with `heatmap=True` on a patch-mode model
        the base64 PNG is decoded to a (H, W) uint8 array under
        ``"heatmap"``."""
        path = self._score_path + ("?heatmap=1" if heatmap else "")
        delay = self.backoff_s
        for attempt in range(self.retries + 1):
            try:
                out = self._json("POST", path, body)
                break
            except Overloaded:
                if attempt == self.retries:
                    raise
                time.sleep(delay)
                delay *= 2
        if "heatmap_b64" in out:
            import base64

            from PIL import Image

            png = base64.b64decode(out.pop("heatmap_b64"))
            out["heatmap"] = np.asarray(Image.open(io.BytesIO(png)))
        return out

    def score(self, image: np.ndarray, heatmap: bool = False) -> dict:
        """Score an (H, W, 3) array — float in [0,1] or uint8 — at the
        model's exact input geometry (the npy path is decode-free on
        the server; see serving/server.py input contract)."""
        buf = io.BytesIO()
        np.save(buf, np.asarray(image))
        return self.score_bytes(buf.getvalue(), heatmap=heatmap)

    def score_file(self, path: str | Path, heatmap: bool = False) -> dict:
        """Score an image file by posting its raw bytes (PNG/JPEG/…;
        the server decodes with the SAME pipeline evaluation uses,
        resizing to the model geometry — nothing to install client-side)."""
        return self.score_bytes(Path(path).read_bytes(), heatmap=heatmap)

    # -- introspection ---------------------------------------------------

    def reload(self) -> dict:
        """POST /admin/reload: hot-swap the server's models from their
        artifact paths (re-exported on disk).  Synchronous — the server
        answers once the new scorers are loaded, warmed and swapped, so
        size `timeout` for a load and warmup, not a request."""
        # empty-bytes body (not None) so http.client sends
        # Content-Length: 0
        return self._json("POST", "/admin/reload", body=b"")

    def healthz(self) -> dict:
        return self._json("GET", "/healthz")

    def readyz(self) -> dict:
        """Readiness WITHOUT raising on 503 — "not ready" is a state,
        not an error; inspect ``["ready"]`` / ``["failures"]``."""
        status, raw = self._request("GET", "/readyz")
        return json.loads(raw.decode("utf-8"))

    def stats(self) -> dict:
        return self._json("GET", "/stats")

    def metrics(self) -> str:
        """The raw Prometheus exposition text."""
        status, raw = self._request("GET", "/metrics")
        if status >= 400:
            raise _error_for(status, raw.decode("utf-8", "replace"))
        return raw.decode("utf-8")
