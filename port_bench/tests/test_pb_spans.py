"""The readers of the port's spans (``core/spans.py``, the ``batcher_*_ms``
and ``scorer_*_ms`` metrics) on a hand-built ``core.trace.Trace``, and
``Trace.idle_gaps`` putting a gap down to the span open at its middle."""

import json

import pytest

from port_bench.core import manifest
from port_bench.core.trace import Trace

SPAN_OF = {
    "batcher_collect_ms": "ssad.batcher.collect",
    "batcher_stack_ms": "ssad.batcher.stack",
    "batcher_fanout_ms": "ssad.batcher.fanout",
    "scorer_upload_ms": "ssad.scorer.upload",
    "scorer_launch_ms": "ssad.scorer.launch",
    "scorer_readback_ms": "ssad.scorer.readback",
}
MANIFEST = json.loads(manifest.MANIFEST.read_text())


def _two_batches() -> Trace:
    """Two batches of host spans (µs), each span a different length in
    each batch, and device work inside the launches and read-backs."""
    host = []
    for b, t in enumerate((0.0, 10_000.0)):
        k = 1 + b  # the second batch's spans last twice as long
        host += [("ssad.batcher.collect", t, t + 1000 * k),
                 ("ssad.batcher.stack", t + 1000 * k, t + 1500 * k),
                 ("ssad.batcher.run", t + 1500 * k, t + 4500 * k),
                 ("ssad.scorer.upload", t + 1500 * k, t + 1800 * k),
                 ("ssad.scorer.launch", t + 1800 * k, t + 2600 * k),
                 ("aten::conv", t + 1900 * k, t + 2000 * k),
                 ("ssad.scorer.readback", t + 2600 * k, t + 4500 * k),
                 ("ssad.batcher.fanout", t + 4500 * k, t + 4600 * k)]
    device = [("conv", 2000.0, 4400.0), ("copy", 6000.0, 7000.0), ("conv", 13_800.0, 18_900.0)]
    return Trace(device, host, wall_s=0.02)


@pytest.mark.parametrize("mode", ["patch", "image"])
@pytest.mark.parametrize("metric", sorted(SPAN_OF))
def test_reader_gives_the_mean_of_its_span(metric, mode):
    trace = _two_batches()
    durations = [e - s for n, s, e in trace.host if n == SPAN_OF[metric]]
    assert len(durations) == 2 and durations[1] == 2 * durations[0]
    read = manifest.reader(f"{metric}.{mode}")
    assert read({"mode": mode, "trace": trace}) == pytest.approx(
        sum(durations) / 2 / 1e3)
    other = "image" if mode == "patch" else "patch"
    assert read({"mode": other, "trace": trace}) is None
    assert read({"mode": mode, "trace": None}) is None
    # a program without the span (the parent of the spans) reads None
    bare = Trace(trace.device, [op for op in trace.host if not op[0].startswith("ssad.")],
                 trace.wall_s)
    assert read({"mode": mode, "trace": bare}) is None


def test_the_twelve_span_metrics_are_in_the_manifest():
    entries = {m["name"]: m for m in MANIFEST["per_layer"]}
    for mode, moves, cells in (
            ("patch", "patch_maps_per_s", ["r18_patch_serve", "wrn50_patch_serve"]),
            ("image", "image_verdicts_per_s", ["r18_image_serve"])):
        for metric in SPAN_OF:
            e = entries[f"{metric}.{mode}"]
            assert e["unit"] == "ms/batch" and e["source"] == "device_trace"
            assert e["moves"] == moves and e["workloads"] == cells
            assert e["layer"] == metric.split("_")[0]


def test_a_gap_inside_a_span_is_put_down_to_it():
    # idle between device ops: 4400-6000 (middle 5200, after the first
    # batch's fanout: no op) and 7000-13800 (middle 10400, inside the
    # second batch's collect)
    gaps = dict(_two_batches().idle_gaps())
    assert gaps == pytest.approx({"host: no op traced": 1600 / 1e6,
                                  "ssad.batcher.collect": 6800 / 1e6})


def test_the_innermost_span_at_the_middle_names_the_gap():
    host = [("ssad.batcher.run", 0.0, 10_000.0), ("ssad.scorer.readback", 3000.0, 9000.0),
            ("ssad.batcher.fanout", 10_000.0, 10_500.0)]
    device = [("k", 0.0, 1000.0), ("k", 5000.0, 6000.0), ("k", 6400.0, 7000.0),
              ("k", 9500.0, 9800.0), ("k", 10_400.0, 11_000.0)]
    gaps = dict(Trace(device, host, wall_s=0.011).idle_gaps())
    # 1000-5000 (middle 3000, inside readback), 6000-6400 (readback),
    # 7000-9500 (middle 8250, readback), 9800-10400 (middle 10100, fanout)
    assert gaps == pytest.approx({"ssad.scorer.readback": (4000 + 400 + 2500) / 1e6,
                                  "ssad.batcher.fanout": 600 / 1e6})
