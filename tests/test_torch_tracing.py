"""The port's spans (utils/profiling.span) and the batcher's lifetime
counters, on the CPU.

Held:
* ``span`` is a plain CPU op of its exact name under ``torch.profiler``
  (not a user annotation, which the profiler would mirror as a
  device-side event), and records nothing when no profiler runs;
* a ``BatchingScorer`` over a tiny patch-mode and image-mode
  ``ServedScorer``, profiled from the collector thread, gives each batch
  one ``collect``, ``stack``, ``run`` and ``fanout`` in that order; the
  scorer's spans nest inside ``run`` and the path's inside ``launch``;
  the four batcher spans cover at least 95 % of the collector's time
  from the first ``collect`` to the last ``fanout``;
* ``queue_wait_s_total`` and ``latency_s_total`` are the sums over the
  answered requests of submit → the scorer call's start and submit →
  its end, worked out from the requests' own submit times and a stub
  scorer that sleeps a known time; two reads give a window's mean;
* the served outputs are the same with the spans as with none;
* the trainer's step carries the spans named in ``STEP_GROUPS``.
"""

import contextlib
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from ssad_tpu_torch.config import ModelConfig
from ssad_tpu_torch.evaluation import inference
from ssad_tpu_torch.models.peranet import build_model
from ssad_tpu_torch.serving import export
from ssad_tpu_torch.serving.export import ServedScorer
from ssad_tpu_torch.serving.server import BatchingScorer
from ssad_tpu_torch.utils.profiling import span

torch.set_num_threads(1)
BATCHER = ("ssad.batcher.collect", "ssad.batcher.stack", "ssad.batcher.run",
           "ssad.batcher.fanout")
SCORER = ("ssad.scorer.upload", "ssad.scorer.launch", "ssad.scorer.readback")
PATH = {"patch": ("ssad.patch.windows", "ssad.patch.stem", "ssad.patch.forward",
                  "ssad.patch.knn", "ssad.patch.maps"),
        "image": ("ssad.image.forward", "ssad.image.knn")}
GEOMETRY = {"patch": dict(imsize=48, batch=2), "image": dict(imsize=64, batch=4)}
#: batches profiled: the profiler stops inside the last one's scorer call
BATCHES = 4


def _host_ops(prof):
    """[(name, start µs, end µs)] of the trace's CPU ops, by start."""
    return sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CPU), key=lambda t: t[1])


def _scorer(mode: str) -> ServedScorer:
    torch.manual_seed(0)
    cfg = ModelConfig(compute_dtype="float32")
    size, batch = GEOMETRY[mode]["imsize"], GEOMETRY[mode]["batch"]
    meta = {"mode": mode, "batch": batch, "imsize": [size, size], "k": 3, "threshold": 0.5,
            "patch_dim": 32, "stride": 8, "upsample_to": size if mode == "patch" else None,
            "scorer": "knn", "model": dataclasses.asdict(cfg), "weights_dtype": "float32"}
    bank = torch.randn(40, cfg.latent_dim, generator=torch.Generator().manual_seed(1))
    return ServedScorer(meta, build_model(cfg).state_dict(), "cpu", bank=bank)


def _images(mode: str, n: int) -> np.ndarray:
    size = GEOMETRY[mode]["imsize"]
    return np.random.default_rng(2).uniform(0, 1, (n, size, size, 3)).astype(np.float32)


class _ProfiledCalls:
    """The scoring callable with ``torch.profiler`` started on the
    collector thread (the batcher's warm-up runs there) and stopped
    inside the ``stop_at``-th call, once the scorer has returned."""

    def __init__(self, fn, stop_at: int):
        self.fn, self.stop_at, self.calls = fn, stop_at, 0
        self.prof = profile(activities=[ProfilerActivity.CPU])
        self.stopped = threading.Event()

    def warm(self, _fn) -> float:
        self.prof.start()
        return 0.0

    def __call__(self, x):
        out = self.fn(x)
        self.calls += 1
        if self.calls == self.stop_at:
            self.prof.stop()
            self.stopped.set()
        return out


@pytest.fixture(scope="module", params=["patch", "image"])
def served(request):
    """(mode, the scorer, the profiled stretch's host ops)."""
    mode = request.param
    scorer = _scorer(mode)
    batch = scorer.batch
    calls = _ProfiledCalls(scorer, BATCHES)
    sc = BatchingScorer(calls, batch=batch, max_delay_ms=50.0, warmup=calls.warm)
    try:
        reqs = [sc.submit(im) for im in _images(mode, batch * BATCHES)]
        assert all(r.event.wait(120) for r in reqs)
        assert calls.stopped.wait(10)
    finally:
        sc.close()
    return mode, scorer, _host_ops(calls.prof)


def _named(ops, names):
    return [op for op in ops if op[0] in names]


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_span_is_a_plain_cpu_op_of_its_name():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("ssad.test.block"):
            torch.ones(4).add_(1)
        with record_function("ssad.test.annotation"):
            torch.ones(4).add_(1)
    by_name = {e.name: e for e in prof.events()}
    ours = by_name["ssad.test.block"]
    assert ours.device_type == torch.autograd.DeviceType.CPU
    assert ours.is_user_annotation is False
    # the primitive it replaces is a user annotation, mirrored on the device
    assert by_name["ssad.test.annotation"].is_user_annotation is True
    assert sum(e.name == "ssad.test.block" for e in prof.events()) == 1


def test_span_records_nothing_without_a_profiler():
    with span("ssad.test.before"):  # closed before the profiler starts
        torch.ones(4).add_(1)
    with span("ssad.test.open_at_start"):  # open when the profiler starts
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            torch.ones(4).add_(1)
    names = {e.name for e in prof.events()}
    assert "aten::add_" in names
    assert not any(n.startswith("ssad.") for n in names), names


def test_each_batch_has_one_of_each_batcher_span(served):
    _, _, ops = served
    order = [name for name, _, _ in _named(ops, BATCHER)]
    # the last batch's fanout falls after the profiler stopped
    assert order == list(BATCHER) * (BATCHES - 1) + list(BATCHER[:3]), order


def test_scorer_spans_nest_in_run_and_path_spans_in_launch(served):
    mode, _, ops = served
    runs = _named(ops, {"ssad.batcher.run"})
    launches = _named(ops, {"ssad.scorer.launch"})
    assert len(runs) == len(launches) == BATCHES
    for run in runs:
        assert [n for n, s, e in _named(ops, SCORER) if _inside((n, s, e), run)] == list(SCORER)
    for launch in launches:
        inner = [n for n, s, e in _named(ops, PATH[mode]) if _inside((n, s, e), launch)]
        assert inner == list(PATH[mode]), inner
    # no path span outside a launch, no scorer span outside a run
    assert len(_named(ops, PATH[mode])) == BATCHES * len(PATH[mode])
    assert len(_named(ops, SCORER)) == BATCHES * len(SCORER)


def test_batcher_spans_tile_the_collector_thread(served):
    _, _, ops = served
    spans = _named(ops, BATCHER)
    first = spans[0][1]
    last = max(e for n, _, e in spans if n == "ssad.batcher.fanout")
    covered, reach = 0.0, first
    for _, s, e in spans:
        s, e = max(s, reach), min(e, last)
        if e > s:
            covered += e - s
            reach = e
    assert covered / (last - first) >= 0.95, covered / (last - first)


@pytest.mark.parametrize("mode", ["patch", "image"])
def test_served_outputs_unchanged_by_the_spans(monkeypatch, mode):
    scorer, x = _scorer(mode), _images(mode, 3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = scorer(x)
    plain = scorer(x)
    # one upload, launch and read-back per chunk of the artifact's batch
    chunks = -(-x.shape[0] // scorer.batch)
    names = [n for n, _, _ in _host_ops(prof)]
    assert [names.count(n) for n in SCORER] == [chunks] * len(SCORER)
    for module in (export, inference):
        monkeypatch.setattr(module, "span", lambda name: contextlib.nullcontext())
    none = scorer(x)
    for a, b, c in zip(traced, plain, none):
        assert np.array_equal(a, c) and np.array_equal(b, c)


class _SleepingStub:
    """Row sums after ``delay_s``; records (start, end, first pixel of each
    row) of every call."""

    def __init__(self, delay_s: float):
        self.delay_s, self.calls = delay_s, []

    def __call__(self, x):
        t0 = time.perf_counter()
        time.sleep(self.delay_s)
        self.calls.append((t0, time.perf_counter(), x[:, 0, 0, 0].tolist()))
        return (x.reshape(x.shape[0], -1).sum(axis=1),)


def _wave(sc, stub, ids):
    """Submit one image per id, wait for all → (Σ submit → call start,
    Σ submit → call end) worked out from the requests and the stub."""
    first_call = len(stub.calls)
    reqs = {i: sc.submit(np.full((2, 2, 3), float(i), np.float32)) for i in ids}
    assert all(r.event.wait(30) and r.error is None for r in reqs.values())
    call_of = {int(v): (t0, t1) for t0, t1, rows in stub.calls[first_call:] for v in rows}
    wait = sum(call_of[i][0] - r.t_submit for i, r in reqs.items())
    latency = sum(call_of[i][1] - r.t_submit for i, r in reqs.items())
    return wait, latency


def test_counters_are_the_sums_over_the_answered_requests():
    delay = 0.03
    stub = _SleepingStub(delay)
    sc = BatchingScorer(stub, batch=4, max_delay_ms=5.0)
    try:
        st0 = sc.stats()
        wait, latency = _wave(sc, stub, range(1, 11))
        st = sc.stats()
    finally:
        sc.close()
    assert st0["queue_wait_s_total"] == st0["latency_s_total"] == 0.0
    assert st["requests"] == 10
    # the call's own entry and return sit a few µs inside the batcher's clock
    assert st["queue_wait_s_total"] == pytest.approx(wait, abs=10 * 2e-3)
    assert st["latency_s_total"] == pytest.approx(latency, abs=10 * 2e-3)
    assert st["latency_s_total"] - st["queue_wait_s_total"] >= 10 * delay


def test_two_reads_of_the_counters_give_a_window_mean():
    stub = _SleepingStub(0.02)
    sc = BatchingScorer(stub, batch=3, max_delay_ms=5.0)
    try:
        _wave(sc, stub, range(1, 7))
        a = sc.stats()
        wait, latency = _wave(sc, stub, range(7, 16))
        b = sc.stats()
    finally:
        sc.close()
    n = b["requests"] - a["requests"]
    assert n == 9
    mean_wait = (b["queue_wait_s_total"] - a["queue_wait_s_total"]) / n
    mean_latency = (b["latency_s_total"] - a["latency_s_total"]) / n
    assert mean_wait == pytest.approx(wait / n, abs=2e-3)
    assert mean_latency == pytest.approx(latency / n, abs=2e-3)


def test_a_failed_batch_adds_nothing_to_the_counters():
    def failing(x):
        raise RuntimeError("planted")

    sc = BatchingScorer(failing, batch=2, max_delay_ms=5.0)
    try:
        reqs = [sc.submit(np.zeros((2, 2, 3), np.float32)) for _ in range(3)]
        assert all(r.event.wait(30) and r.error is not None for r in reqs)
        st = sc.stats()
    finally:
        sc.close()
    assert st["requests"] == 0
    assert st["queue_wait_s_total"] == st["latency_s_total"] == 0.0


def test_trainer_step_spans_are_the_step_groups():
    from ssad_tpu_torch.train import step_parity as sp
    from ssad_tpu_torch.train.trainer import STEP_GROUPS, Trainer, stage_generator

    tr = Trainer(sp.step_config((32, 32), 4), sp.disc_data(32), "cpu")
    state = tr.init_state("fine_tune", seed=0)
    dd = tr.device_data("train")
    uploaded = tr.upload_draws(stage_generator(0, 2), dd)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.train_step(state, uploaded, dd, fill=True)
    steps = [(n, s) for n, s, _ in _host_ops(prof) if n.startswith("ssad.")]
    assert [n for n, _ in steps] == list(STEP_GROUPS), steps
    assert all(e.is_user_annotation is False for e in prof.events() if e.name in STEP_GROUPS)


def test_a_profiler_started_or_stopped_inside_a_span_leaves_it_whole():
    """The harness starts and stops the profiler inside the batcher's
    ``run`` span, on the collector thread."""
    prof = profile(activities=[ProfilerActivity.CPU])
    with span("ssad.test.started_inside"):
        prof.start()
        torch.ones(4).add_(1)
    with span("ssad.test.stopped_inside"):
        torch.ones(4).add_(1)
        prof.stop()
    with span("ssad.test.after"):
        torch.ones(4).add_(1)
    names = [e.name for e in prof.events() if e.name.startswith("ssad.")]
    assert names == ["ssad.test.stopped_inside"], names
