"""Closed-loop serving: ``clients`` clients, each sending its next image to
the port's ``BatchingScorer`` only when its verdict has come back, as an
inspection station holds a part until its verdict; one load thread drives
them all (``drive``).

Set-up is the export users run, in memory: seeded weights into the port's
PeraNet, the normality embedded by ``normality_embeddings`` (patch mode:
every window of ``normality_images`` images, ``normality_batch`` images a
forward, as ``export --mode patch`` without ``--n-normality-images``;
image mode: one row per image), the 70/30 fit of ``make_detector``, and
a ``ServedScorer`` over the weights and the bank, warmed on the batcher's
thread at the artifact's one batch shape.  No file is written.

The window sends seeded images from a pool for ``seconds``; every request
is timed from the client's side.  Once it has closed the plain reference
(``port_bench/reference``) works out the normality, the split, the bank
(and in image mode the threshold) again from the same weights and images
and scores a seeded sample of the window's requests; ``compare`` gives
the numbers that decide ``correct``.

Traffic parameters (``port_bench/traffic/<traffic>.json``): ``mode``
('patch' | 'image'), ``imsize`` (square RGB images), ``batch``,
``clients``, ``max_delay_ms``, ``max_queue``, ``normality_images``,
``normality_batch``, ``pool_images``, ``sample``, ``timeout_s``; patch
mode ``patch_dim`` and ``stride``; ``end_to_end``: {manifest metric:
quantity of ``Window.quantities``}.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from port_bench.core import seeded
from port_bench.core.trace import Profiler, warm_profiler
from port_bench.reference import peranet as ref_net
from port_bench.reference import scoring as ref


def model_config(cfg: dict):
    """The port's ModelConfig for a configuration file."""
    from ssad_tpu_torch.config import ModelConfig

    return ModelConfig(backbone=cfg["backbone"], layer_outputs=tuple(cfg["layer_outputs"]),
                       latent_space_layers=cfg["latent_space_layers"],
                       latent_dim=cfg["latent_dim"], num_classes=cfg["num_classes"],
                       compute_dtype=cfg["compute_dtype"])


def shapes(cfg: dict):
    return ref_net.state_shapes(cfg["backbone"], cfg["layer_outputs"],
                                cfg["latent_space_layers"], cfg["latent_dim"],
                                cfg["num_classes"])


def patch_geometry(tr: dict) -> Optional[dict]:
    return {"dim": tr["patch_dim"], "stride": tr["stride"]} if tr["mode"] == "patch" else None


class TimedScorer:
    """The scorer callable the batcher runs, with the host clock (and the
    call's own sync: it returns host arrays) around each call.  On request
    it starts and stops the profiler from the batcher's thread, which runs
    every op of the served path (the profiler records the host ops of the
    thread that starts it)."""

    def __init__(self, scorer):
        self.scorer = scorer
        self.calls: List[tuple] = []  # (start, end) perf_counter seconds
        self.profiler: Optional[Profiler] = None
        self.profile_from = self.profile_until = float("inf")
        self.profile_s = 0.0
        self.profiled = threading.Event()

    def __call__(self, x):
        prof = self.profiler
        if prof is not None and prof.waiting and time.perf_counter() >= self.profile_from:
            prof.start()
            self.profile_until = time.perf_counter() + self.profile_s
        t0 = time.perf_counter()
        out = self.scorer(x)
        t1 = time.perf_counter()
        self.calls.append((t0, t1))
        if prof is not None and prof.running and t1 >= self.profile_until:
            prof.stop()
            self.profiled.set()
        return out


def build_scorer(cfg: dict, tr: dict, state: Dict[str, torch.Tensor], seed: int, device,
                 weights_dtype: Optional[str] = None, phases: Optional[dict] = None):
    """(ServedScorer, bank rows, the fit's threshold): ``export``'s steps in
    memory.  ``weights_dtype`` 'int8' / 'bfloat16' stores the served
    weights as the port's quantized artifacts do (the normality is
    embedded with the full weights either way).  ``phases`` gets the
    seconds of each step."""
    from ssad_tpu_torch.evaluation.inference import InferenceEngine, normality_embeddings
    from ssad_tpu_torch.models.detector import make_detector
    from ssad_tpu_torch.models.peranet import build_model
    from ssad_tpu_torch.serving.export import ServedScorer, serving_weights

    phases = {} if phases is None else phases
    t = time.perf_counter()
    mcfg = model_config(cfg)
    model = build_model(mcfg)
    model.load_state_dict(state, strict=True)
    engine = InferenceEngine(model, device)
    size = tr["imsize"]
    geometry = patch_geometry(tr)
    normal_images = seeded.images(tr["normality_images"], size, seed, "normality", device)
    normality = normality_embeddings(
        engine, None, normal_images.cpu().numpy(), batch_size=tr["normality_batch"],
        min_bank_rows=10**9, patch_localization=geometry is not None,
        **({"patch_dim": geometry["dim"], "stride": geometry["stride"]} if geometry else {}))
    del normal_images, engine, model
    t, phases["normality_s"] = time.perf_counter(), time.perf_counter() - t
    det = make_detector("knn", k=cfg["knn_k"])
    det.fit(normality, torch.Generator().manual_seed(seeded.stream(seed, "split")))
    bank, threshold = det.bank, float(det.threshold)
    del normality, det
    t, phases["fit_s"] = time.perf_counter(), time.perf_counter() - t
    meta = {
        "mode": tr["mode"], "batch": tr["batch"], "imsize": [size, size], "k": cfg["knn_k"],
        "threshold": threshold, "patch_dim": tr.get("patch_dim", 32),
        "stride": tr.get("stride", 8), "upsample_to": size if geometry else None,
        "scorer": "knn", "model": dataclasses.asdict(mcfg),
        "weights_dtype": weights_dtype or "float32",
    }
    weights, scales = serving_weights(state, weights_dtype)
    scorer = ServedScorer(meta, weights, device, scales=scales, bank=bank)
    phases["scorer_s"] = time.perf_counter() - t
    return scorer, int(bank.shape[0]), threshold


@dataclasses.dataclass
class Window:
    """What the window did, from the clients' side."""

    seconds: float
    start: float
    end: float
    submits: np.ndarray  # per request: submit time (perf_counter s)
    dones: np.ndarray  # per request: verdict time, nan where it failed
    pool_index: np.ndarray  # per request: the pool image it sent
    results: list  # per request: the returned rows, None where it failed
    calls: List[tuple]  # scorer calls started inside the window
    trace: Optional[object]  # core.trace.Trace of the profiled stretch
    traced: Optional[tuple]  # its (start, end), perf_counter seconds

    def quiet_calls(self) -> List[tuple]:
        """Scorer calls of the window that do not overlap the profiled
        stretch: the host-clock readers' sample, free of its overhead."""
        if self.traced is None:
            return self.calls
        a, b = self.traced
        return [c for c in self.calls if c[1] <= a or c[0] >= b]

    def quiet_p95_ms(self, timeout_s: float) -> Optional[float]:
        """``quantities``' p95 over the requests that do not overlap the
        profiled stretch."""
        lat = np.where(self.ok, self.dones - self.submits, timeout_s)
        keep = np.ones(lat.shape, bool)
        if self.traced is not None:
            a, b = self.traced
            keep = (self.submits + lat <= a) | (self.submits >= b)
        return float(np.percentile(lat[keep], 95) * 1e3) if keep.any() else None

    def quiet_rate(self) -> float:
        """Verdicts per second returned inside the window and outside the
        profiled stretch."""
        ok = self.ok & (self.dones <= self.end)
        span = self.seconds
        if self.traced is not None:
            a, b = self.traced
            ok &= (self.dones <= a) | (self.dones >= b)
            span -= min(b, self.end) - a
        return float(np.sum(ok) / span)

    @property
    def ok(self) -> np.ndarray:
        return ~np.isnan(self.dones)

    def quantities(self, timeout_s: float) -> dict:
        """rate: verdicts returned inside the window per second; p95_ms:
        the 95th percentile of submit → verdict over every request sent
        in the window (a failed one counts as the timeout)."""
        done_in = np.sum(self.ok & (self.dones <= self.end))
        lat = np.where(self.ok, self.dones - self.submits, timeout_s) * 1e3
        return {"rate": float(done_in / self.seconds),
                "p95_ms": float(np.percentile(lat, 95)) if lat.size else None}


def drive(batcher, pool: np.ndarray, tr: dict, seconds: float, seed: int,
          timed: TimedScorer, trace: bool) -> Window:
    """``clients`` closed-loop clients from one load thread.  The batcher
    answers in the order it was asked (one collector, FIFO batches), so the
    thread waits on the oldest request, records it, and sends that client's
    next image: each client has one request out at a time, and the load
    costs one thread, not one per client (client threads fighting for the
    interpreter lock would make the harness, not the port, set the pace).
    A request's answer is timed when the thread takes it, microseconds
    after it is set for the later rows of a batch."""
    from ssad_tpu_torch.serving.server import Overloaded

    n_clients, timeout = tr["clients"], tr["timeout_s"]
    rng = np.random.default_rng(seeded.stream(seed, "order"))
    orders = [rng.permutation(len(pool)) for _ in range(n_clients)]
    sent = [0] * n_clients
    log = []  # (submit, done | nan, pool index, result)
    clock = {}

    def send(c: int, pending: collections.deque) -> None:
        while True:
            t0 = time.perf_counter()
            if t0 >= clock["end"]:
                return
            idx = int(orders[c][sent[c] % len(pool)])
            sent[c] += 1
            try:
                pending.append((c, t0, idx, batcher.submit(pool[idx])))
                return
            except Overloaded:  # shed: a failure, and the client asks again
                log.append((t0, float("nan"), idx, None))

    def load():
        pending = collections.deque()
        for c in range(n_clients):
            send(c, pending)
        while pending:
            c, t0, idx, req = pending.popleft()
            ok = req.event.wait(timeout) and req.error is None
            log.append((t0, time.perf_counter() if ok else float("nan"), idx,
                        req.result if ok else None))
            send(c, pending)

    # the set-up's objects out of the collector's way: a full collection
    # over them in the window would be the harness's pause, not the port's
    gc.collect()
    gc.freeze()
    start = time.perf_counter()
    clock["end"] = end = start + seconds
    loader = threading.Thread(target=load, daemon=True)
    loader.start()
    prof = None
    if trace:
        timed.profile_from = start + min(2.0, 0.2 * seconds)
        timed.profile_s = min(3.0, 0.4 * seconds)
        timed.profiler = prof = Profiler()
    loader.join(timeout=seconds + n_clients * timeout + 5)
    if loader.is_alive():
        raise RuntimeError("the load thread is still waiting past the window and its timeouts")
    if prof is not None and not timed.profiled.is_set():
        raise RuntimeError("the profiled stretch did not close inside the window")
    gc.unfreeze()
    log.sort(key=lambda r: r[0])
    return Window(
        seconds=seconds, start=start, end=end,
        submits=np.array([r[0] for r in log], np.float64),
        dones=np.array([r[1] for r in log], np.float64),
        pool_index=np.array([r[2] for r in log], np.int64),
        results=[r[3] for r in log],
        calls=[c for c in timed.calls if start <= c[0] < end],
        trace=prof.reduce() if prof else None,
        traced=prof.interval if prof else None,
    )


def compare(mode: str, program: dict, reference: dict) -> dict:
    """The numbers that decide ``correct``, program against reference.

    patch: ``map_gap`` the largest |Δ| over the sampled maps, and
    ``map_rms`` the root-mean-square Δ, both over the largest reference
    value; image: ``score_gap`` the largest |Δscore| and ``threshold_gap``
    |Δthreshold|, over the reference threshold, ``logit_gap`` the largest
    |Δlogit| over the largest reference |logit|, and ``label_flips`` the
    sampled labels that differ from the reference's where its score lies
    further than ``score_gap``'s limit from its threshold (``flip_band``)."""
    if mode == "patch":
        d = (program["maps"] - reference["maps"]).abs()
        scale = reference["maps"].abs().max()
        return {"map_gap": float(d.max() / scale),
                "map_rms": float(d.pow(2).mean().sqrt() / scale)}
    thr = reference["threshold"]
    score_d = (program["scores"] - reference["scores"]).abs()
    out = {
        "score_gap": float(score_d.max() / thr),
        "threshold_gap": abs(program["threshold"] - thr) / thr,
        "logit_gap": float((program["logits"] - reference["logits"]).abs().max()
                           / reference["logits"].abs().max()),
    }
    band = reference.get("flip_band", 0.0) * thr
    clear = (reference["scores"] - thr).abs() > band
    ref_labels = reference["scores"] > thr
    out["label_flips"] = int(((program["labels"] != ref_labels) & clear).sum())
    return out


def program_outputs(mode: str, window: Window, picks: np.ndarray, threshold: float) -> dict:
    """The served rows of the sampled requests, as float64 host tensors."""
    rows = [window.results[i] for i in picks]
    if mode == "patch":
        return {"maps": torch.from_numpy(np.concatenate([r[0] for r in rows])).double()}
    return {"scores": torch.from_numpy(np.concatenate([r[0] for r in rows])).double(),
            "labels": torch.from_numpy(np.concatenate([r[1] for r in rows]) > 0),
            "logits": torch.from_numpy(np.concatenate([r[2] for r in rows])).double(),
            "threshold": threshold}


def reference_outputs(cfg: dict, tr: dict, seed: int, device, pool_index: np.ndarray,
                      precision: ref_net.Precision = ref_net.Precision(),
                      flip_band: float = 0.0) -> dict:
    """The plain reference's outputs for the pool images ``pool_index``,
    everything worked out again from the seeded weights and images."""
    state = seeded.fill_state(shapes(cfg), seed, device)
    net = ref_net.PeraNetReference(state, cfg["backbone"], cfg["layer_outputs"],
                                   cfg["latent_space_layers"], precision)
    size, geometry, k = tr["imsize"], patch_geometry(tr), cfg["knn_k"]
    normality = ref.embed(net, seeded.images(tr["normality_images"], size, seed, "normality",
                                             device), geometry)
    bank, threshold = ref.fit(normality, k, seeded.stream(seed, "split"), precision)
    del normality
    picked = seeded.images(tr["pool_images"], size, seed, "requests", device)[
        torch.as_tensor(pool_index, device=device)]
    if geometry is not None:
        maps = torch.cat([ref.patch_maps(net, picked[lo:lo + 8], bank, k, geometry["dim"],
                                         geometry["stride"], precision)
                          for lo in range(0, picked.shape[0], 8)])
        return {"maps": maps.double().cpu()}
    logits, emb = [], []
    for lo in range(0, picked.shape[0], 64):
        lg, e = net.forward(ref_net.normalize(picked[lo:lo + 64]))
        logits.append(lg)
        emb.append(e)
    scores = ref.knn_scores(torch.cat(emb), bank, k, precision)
    return {"scores": scores.double().cpu(), "logits": torch.cat(logits).double().cpu(),
            "labels": (scores > threshold).cpu(), "threshold": threshold,
            "flip_band": flip_band}


def sample(window: Window, n: int, seed: int) -> np.ndarray:
    """A seeded sample of ``n`` of the window's answered requests."""
    answered = np.flatnonzero(window.ok)
    rng = np.random.default_rng(seeded.stream(seed, "sample"))
    return np.sort(rng.choice(answered, size=min(n, answered.size), replace=False))


def free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def _warm(scorer, trace: bool) -> float:
    """The batcher's warm-up, on its own thread: the scorer at its batch
    shape, and in a traced run the profiler's start-up."""
    t0 = time.perf_counter()
    if trace:
        warm_profiler()
    scorer.warmup()
    return time.perf_counter() - t0


def run(cell, seed: int, seconds: float, trace: bool, device) -> dict:
    """Set up, drive the window, free the program, check against the
    reference.  Returns the driver's result for run.py; ``window_start``
    (perf_counter seconds) ends the set-up."""
    from ssad_tpu_torch.serving.server import BatchingScorer

    cfg, tr = cell.config, cell.traffic
    t = time.perf_counter()
    state = seeded.fill_state(shapes(cfg), seed, device)
    phases = {"weights_s": time.perf_counter() - t}
    scorer, bank_rows, threshold = build_scorer(cfg, tr, state, seed, device, phases=phases)
    del state
    t = time.perf_counter()
    pool = seeded.images(tr["pool_images"], tr["imsize"], seed, "requests", device).cpu().numpy()
    timed = TimedScorer(scorer)
    batcher = BatchingScorer(timed, batch=tr["batch"], max_delay_ms=tr["max_delay_ms"],
                             max_queue=tr["max_queue"], warmup=lambda fn: _warm(scorer, trace))
    phases["warmup_s"] = time.perf_counter() - t
    try:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        window = drive(batcher, pool, tr, seconds, seed, timed, trace)
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    finally:
        batcher.close()
    del scorer, timed, batcher, pool
    free(device)

    picks = sample(window, tr["sample"], seed)
    program = program_outputs(tr["mode"], window, picks, threshold)
    limits = cell.limits
    reference = reference_outputs(cfg, tr, seed, device, window.pool_index[picks],
                                  flip_band=limits.get("score_gap", 0.0))
    numbers = compare(tr["mode"], program, reference)
    phases["reference_s"] = time.perf_counter() - window.end
    q = window.quantities(tr["timeout_s"])
    ctx = {"mode": tr["mode"], "config": cfg, "traffic": tr, "window": window,
           "bank_rows": bank_rows, "quantities": q}
    return {
        "attempted": int(window.submits.size),
        "failed": int(np.sum(~window.ok)),
        "end_to_end": {name: q[key] for name, key in tr["end_to_end"].items()},
        "ctx": ctx,
        "numbers": numbers,
        "sampled": int(picks.size),
        "memory_peak_bytes": int(peak),
        "trace": window.trace,
        "window_start": window.start,
        "phases": phases,
    }
