"""The port's device replicas and the batcher's runner pool
(ssad_tpu_torch/serving/replicas.py, server.BatchingScorer over a list of
callables) against the JAX package's (ssad_tpu/serving/replicas.py,
server.py:67-275; its own tests: tests/test_serving_replicas.py).

Held, with stub callables (no device on the hot path):
* fan-out: 48 concurrent distinct images through 4 runners, every
  caller gets its own result (exact);
* concurrency: 4 full batches on 4 runners sleeping 0.25 s each finish
  in under 0.75 s (serial: 1 s; measured 0.2508–0.2510 s, 5 runs);
* each callable runs on one runner thread only and never overlaps
  itself, while runners do overlap one another;
* ``stats()``: ``replicas`` and ``replica_batches`` (summing to
  ``batches``) with several callables, and the JAX batcher's keys (plus
  the port's two lifetime sums) and counters from the same submissions;
  one callable: no replica keys;
* a failing batch fails only its own requests; ``close()`` joins with
  staged batches and leaves no request waiting, and a collector wedged
  in a long call is not drained under it;
* the warm-up runs once per callable on that callable's own runner
  thread and counts no request or batch;
* ``pick_devices``: 0 or None = all, over-asking raises with the cards
  listed (a card count faked on the CPU), n CPU entries on the CPU.
With an artifact of one set of weights (imsize 64, batch 4, the port's
``export_checkpoint`` and JAX's ``export_scorer`` on the port's bank and
threshold, as tests/test_torch_serving.py builds them): 4 CPU replicas
through the port's batcher give the port's direct ``ServedScorer`` scores
image for image within 1e-6 (measured 0: the same f32 program) and the
JAX artifact's within 2e-5 (the serving tests' image-score tolerance;
measured 5.96e-8), labels where the score is clear of the threshold.
A spy on ``torch.cuda.device`` shows a replica on ``cuda:1`` calls and
warms its scorer inside that device's context (no card needed: the
scorer is a stub that reads the spy's current device).

Planted faults that break these: every runner calling ``self._fns[0]``
(the one-callable-per-thread test fails: callable 0 overlaps itself);
``DeviceReplica.__call__`` without ``device_context`` (the spy test
fails); a collector that runs every batch itself instead of handing it
to a runner (the concurrency test).
"""

import contextlib
import threading
import time

import numpy as np
import pytest
import torch
from _torch_port import jax_variables, seeded
from test_ref_checkpoint import reference_state_dict

from ssad_tpu.serving import server as jserver
from ssad_tpu_torch.serving import replicas
from ssad_tpu_torch.serving import server as pserver

torch.set_num_threads(1)
IMSIZE, BATCH = 64, 4


def _sum_scorer(x):
    s = x.reshape(x.shape[0], -1).sum(axis=1)
    return s, (s > 100).astype(np.int32)


def _make_slow(delay_s, calls):
    def fn(x):
        calls.append(threading.get_ident())
        time.sleep(delay_s)
        return _sum_scorer(x)

    return fn


def _img(i):
    return np.full((2, 2, 3), float(i), np.float32)


def _hammer(sc, n, timeout=30):
    """n concurrent callers of sc.score → ({i: result}, [errors])."""
    results, errors = {}, []

    def worker(i):
        try:
            results[i] = sc.score(_img(i), timeout=timeout)
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    return results, errors


def test_fanout_correct_across_replicas():
    sc = pserver.BatchingScorer([_make_slow(0.02, []) for _ in range(4)], batch=4)
    try:
        results, errors = _hammer(sc, 48)
        assert not errors
        for i in range(48):
            assert float(results[i][0]) == 2 * 2 * 3 * i
    finally:
        sc.close()


def test_batches_execute_concurrently():
    calls = []
    sc = pserver.BatchingScorer([_make_slow(0.25, calls) for _ in range(4)], batch=4,
                                max_delay_ms=2.0)
    try:
        reqs = [sc.submit(_img(i)) for i in range(16)]
        t0 = time.perf_counter()
        for r in reqs:
            assert r.event.wait(10) and r.error is None
        wall = time.perf_counter() - t0
    finally:
        sc.close()
    assert len(calls) == 4 and len(set(calls)) >= 2
    assert wall < 0.75, f"4 × 0.25 s batches took {wall:.2f} s: no overlap"


def test_each_callable_runs_on_one_thread_and_never_overlaps_itself():
    lock = threading.Lock()
    threads, active, peak = {}, {}, {"self": 0, "all": 0}

    def make(idx):
        def fn(x):
            with lock:
                threads.setdefault(idx, set()).add(threading.get_ident())
                active[idx] = active.get(idx, 0) + 1
                peak["self"] = max(peak["self"], active[idx])
                peak["all"] = max(peak["all"], sum(active.values()))
            time.sleep(0.03)
            with lock:
                active[idx] -= 1
            return _sum_scorer(x)

        return fn

    sc = pserver.BatchingScorer([make(i) for i in range(3)], batch=2, max_delay_ms=1.0)
    try:
        _, errors = _hammer(sc, 36)
        st = sc.stats()
    finally:
        sc.close()
    assert not errors
    assert peak["self"] == 1, "a callable ran two batches at once"
    assert peak["all"] >= 2, "the runners never overlapped"
    assert all(len(t) == 1 for t in threads.values()), threads
    assert sum(st["replica_batches"]) == st["batches"]


def test_stats_count_per_replica_as_jax_does():
    out = {}
    for which, mod in (("port", pserver), ("jax", jserver)):
        sc = mod.BatchingScorer([_sum_scorer] * 3, batch=2)
        try:
            for i in range(10):
                sc.score(_img(i))
            out[which] = sc.stats()
        finally:
            sc.close()
    port, jax_ = out["port"], out["jax"]
    # the port's two lifetime sums for a window's mean wait and latency
    # are its own; every key of the JAX batcher is there
    assert set(port) == set(jax_) | {"queue_wait_s_total", "latency_s_total"}
    assert port["latency_s_total"] >= port["queue_wait_s_total"] > 0
    for key in ("requests", "batches", "replicas", "max_queue", "queue_depth"):
        assert port[key] == jax_[key], key
    assert port["replicas"] == 3 and port["requests"] == 10
    assert sum(port["replica_batches"]) == port["batches"] == 10
    assert len(port["replica_batches"]) == len(jax_["replica_batches"]) == 3


def test_single_fn_stats_unchanged():
    for mod in (pserver, jserver):
        sc = mod.BatchingScorer(_sum_scorer, batch=2)
        try:
            sc.score(np.ones((2, 2, 3), np.float32))
            assert "replicas" not in sc.stats() and "replica_batches" not in sc.stats()
        finally:
            sc.close()


def test_error_hits_only_its_batch():
    lock, fired = threading.Lock(), [False]

    def flaky(x):
        with lock:
            if not fired[0]:
                fired[0] = True
                raise RuntimeError("kaboom")
        return _sum_scorer(x)

    sc = pserver.BatchingScorer([flaky, flaky], batch=2, max_delay_ms=2.0)
    try:
        results, errors = _hammer(sc, 8, timeout=15)
    finally:
        sc.close()
    assert 1 <= len(errors) <= 2 and all("kaboom" in str(e) for e in errors)
    assert len(results) == 8 - len(errors)


def test_close_drains_and_joins():
    sc = pserver.BatchingScorer([_make_slow(0.05, []) for _ in range(2)], batch=2,
                                max_delay_ms=1.0)
    reqs = [sc.submit(_img(i)) for i in range(8)]
    sc.close()
    assert all(r.event.is_set() for r in reqs)
    assert sum(r.error is None for r in reqs) >= 2
    assert not any(t.is_alive() for t in sc._runners) and not sc._thread.is_alive()
    with pytest.raises(RuntimeError, match="scorer is closed"):
        sc.submit(_img(0))


def test_close_leaves_a_wedged_collector_alone():
    """A collector stuck in a long call keeps its sentinel: close()
    returns, and the collector, once unblocked, runs what is queued or
    cancels it and stops the runners itself."""
    gate = threading.Event()

    def stuck(x):
        gate.wait(10)
        return _sum_scorer(x)

    sc = pserver.BatchingScorer(stuck, batch=1, max_delay_ms=0.1)
    sc._join_s = 0.1
    first = sc.submit(_img(1))
    time.sleep(0.05)
    queued = sc.submit(_img(2))
    sc.close()
    assert sc._thread.is_alive() and not queued.event.is_set()
    gate.set()
    assert first.event.wait(10) and first.error is None
    assert queued.event.wait(10)
    sc._thread.join(10)
    assert not sc._thread.is_alive()


def test_warmup_runs_on_each_runner_thread_and_counts_nothing():
    ran = {}

    class Fn:
        def __init__(self, i):
            self.i = i

        def __call__(self, x):
            assert ran[self.i] == threading.get_ident(), "ran off its warm thread"
            return _sum_scorer(x)

        def warmup(self):
            ran[self.i] = threading.get_ident()
            return 0.5

    fns = [Fn(i) for i in range(3)]
    sc = pserver.BatchingScorer(fns, batch=2, warmup=lambda fn: fn.warmup())
    try:
        assert sc.warmup_s == 1.5 and len(set(ran.values())) == 3
        assert threading.get_ident() not in ran.values()
        st = sc.stats()
        assert (st["requests"], st["batches"], st["replica_batches"]) == (0, 0, [0, 0, 0])
        _, errors = _hammer(sc, 24)
        assert not errors
    finally:
        sc.close()

    def bad(fn):
        raise ValueError("warm-up failed")

    with pytest.raises(ValueError, match="warm-up failed"):
        pserver.BatchingScorer([_sum_scorer, _sum_scorer], batch=2, warmup=bad)


# -- pick_devices ----------------------------------------------------------------


def test_pick_devices_cpu():
    assert replicas.pick_devices(3, "cpu") == [torch.device("cpu")] * 3
    assert replicas.pick_devices(0, "cpu") == [torch.device("cpu")]
    assert replicas.pick_devices(None, torch.device("cpu")) == [torch.device("cpu")]
    with pytest.raises(ValueError):
        replicas.pick_devices(-1, "cpu")


def test_pick_devices_cuda_zero_means_all_and_overask_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "Fake H100")
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert replicas.pick_devices(0) == cards and replicas.pick_devices(None) == cards
    assert replicas.pick_devices(1, "cuda") == cards[:1]
    with pytest.raises(ValueError, match=r"asked for 3 devices but 2 are attached.*Fake H100"):
        replicas.pick_devices(3)


# -- DeviceReplica -----------------------------------------------------------------


def test_device_replica_runs_inside_its_device_context(monkeypatch):
    current = []

    @contextlib.contextmanager
    def spy(device):
        current.append(torch.device(device))
        try:
            yield
        finally:
            current.pop()

    monkeypatch.setattr(torch.cuda, "device", spy)
    seen = []

    class StubScorer:
        device = torch.device("cuda", 1)
        meta = {"imsize": [2, 2], "batch": 2}
        batch = 2

        def __call__(self, x):
            seen.append(("call", list(current)))
            return _sum_scorer(x)

        def warmup(self, max_calls=16, settled_s=0.25):
            seen.append(("warmup", list(current)))
            return 0.0

    rep = replicas.DeviceReplica(StubScorer())
    assert "cuda:1" in repr(rep)
    rep(np.zeros((2, 2, 2, 3), np.float32))
    rep.warmup()
    assert seen == [("call", [torch.device("cuda", 1)]),
                    ("warmup", [torch.device("cuda", 1)])]
    assert current == []


# -- an artifact on 4 CPU replicas -------------------------------------------------------


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    from ssad_tpu.evaluation.inference import InferenceEngine
    from ssad_tpu.serving.export import export_scorer, load_scorer, save_artifact
    from ssad_tpu_torch.config import ModelConfig
    from ssad_tpu_torch.serving.export import export_checkpoint, read_artifact
    from ssad_tpu_torch.utils.ref_checkpoint import save_reference_checkpoint

    root = tmp_path_factory.mktemp("replicas")
    sd = reference_state_dict(seed=0)
    bank = np.random.default_rng(1).standard_normal((40, 512)).astype(np.float32)
    ckpt = root / "bottle" / "best_model.ckpt"
    save_reference_checkpoint(ckpt, sd, bank, ModelConfig(compute_dtype="float32"))
    path = export_checkpoint(ckpt, root / "bottle.ssadpt", batch=BATCH,
                             imsize=(IMSIZE, IMSIZE), subject="bottle", device="cpu")
    meta, payload = read_artifact(path)
    model, params, stats = jax_variables(sd, "float32")
    exported, jmeta = export_scorer(
        InferenceEngine(model, params, stats), payload["bank"].numpy(), mode="image",
        batch=BATCH, imsize=(IMSIZE, IMSIZE), k=3, threshold=meta["threshold"],
        platform="cpu",
    )
    return path, load_scorer(save_artifact(root / "jax.ssadexp", exported, jmeta))


def test_four_cpu_replicas_match_the_direct_scorer_and_jax(artifacts):
    from ssad_tpu_torch.serving.export import ServedScorer

    path, jscorer = artifacts
    reps = replicas.device_replicas(path, replicas.pick_devices(4, "cpu"))
    assert len(reps) == 4 and len({id(r.scorer) for r in reps}) == 4
    params = [next(r.scorer.engine.model.parameters()) for r in reps]
    assert len({p.data_ptr() for p in params}) == 4  # no weight shared
    sc = pserver.BatchingScorer(reps, batch=BATCH, max_delay_ms=10.0,
                                warmup=lambda fn: fn.warmup(max_calls=1))
    imgs = seeded((12, IMSIZE, IMSIZE, 3), 21)
    got = {}

    def worker(i):
        got[i] = sc.score(imgs[i], timeout=120)

    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        st = sc.stats()
    finally:
        sc.close()
    assert len(got) == 12
    assert st["replicas"] == 4 and sum(st["replica_batches"]) == st["batches"]
    scores = np.array([float(got[i][0]) for i in range(12)])
    labels = np.array([int(got[i][1]) for i in range(12)])
    direct, direct_labels, _ = ServedScorer.from_file(path, device="cpu")(imgs)
    np.testing.assert_allclose(scores, direct, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(labels, direct_labels)
    jscores, jlabels, _ = jscorer(imgs)
    np.testing.assert_allclose(scores, jscores, atol=2e-5, rtol=0)
    clear = np.abs(scores - reps[0].meta["threshold"]) > 1e-4
    np.testing.assert_array_equal(labels[clear], jlabels[clear])
