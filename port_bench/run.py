#!/usr/bin/env python3
"""Run one cell of the benchmark of ssad_tpu_torch and print one JSON line.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  The cell is found by name in ``BENCHMARK.json`` and its files
(``port_bench/README.md``); its driver sets up, warms up the cell's own
shapes, measures for ``--seconds``, then checks a seeded sample of what
the window served against the plain reference.

The last line of standard output is ``{"correct", "attempted", "failed",
"metrics", "device"[, "breakdown"], "checks"}``: with ``--trace 0`` the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics read
from a profiled stretch of the window.  ``checks`` (last) and the last
lines of standard error give each number compared beside its limit.

Exits non-zero without a result when there is no CUDA card (or fewer
than the cell asks for), and when JAX, jaxlib, flax or the JAX package
are loaded once the window has closed.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: top-level module names that may not be loaded in the process that prints
FORBIDDEN = ("jax", "jaxlib", "flax", "ssad_tpu")


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def result_line(cell, res: dict, setup_s: float, trace: bool, device) -> dict:
    from port_bench.core import device as dev
    from port_bench.core import manifest

    metrics = {}
    if trace:
        ctx = dict(res["ctx"], trace=res["trace"])
        for m in cell.per_layer:
            value = manifest.reader(m.name)(ctx)
            if value is not None:
                metrics[m.name] = {"value": value, "unit": m.unit}
    else:
        for m in cell.end_to_end:
            value = setup_s if m.name == "setup_s" else res["end_to_end"].get(m.name)
            if value is not None:
                metrics[m.name] = {"value": value, "unit": m.unit}
    checks = {name: {"value": res["numbers"][name], "limit": limit}
              for name, limit in cell.limits.items()}
    correct = res["sampled"] > 0 and all(c["value"] <= c["limit"] for c in checks.values())
    line = {"correct": bool(correct), "attempted": res["attempted"], "failed": res["failed"],
            "metrics": metrics,
            "device": dev.record(device, cell.chips, res["memory_peak_bytes"])}
    tr = res["trace"]
    if trace and tr is not None:
        line["device"].update(busy_s=tr.busy_s, window_s=tr.wall_s)
        line["breakdown"] = tr.breakdown()
    line["checks"] = checks
    return line


def main(argv=None, device=None, root: Path = ROOT) -> int:
    """``device``: None looks for the cards (the benchmark); a given device
    skips that look (the harness's own tests on the CPU).  ``root``: the
    checkout whose manifest and cell files are read."""
    args = parse(argv)
    from port_bench.core import device as dev
    from port_bench.core import manifest

    cell = manifest.resolve_cell(args.workload, root=root)
    if device is None:
        try:
            device = dev.require_cards(cell.chips)
        except dev.NoCard as e:
            print(f"port_bench: {e}", file=sys.stderr)
            return 2
    driver = manifest.driver(cell.traffic["driver"])
    res = driver.run(cell, args.seed, args.seconds, bool(args.trace), device)
    found = forbidden_modules()
    if found:
        print(f"port_bench: loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    line = result_line(cell, res, res["window_start"] - T_PROCESS, bool(args.trace), device)
    print("phases: " + json.dumps(res.get("phases", {})), file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"correct: {line['correct']} ({res['sampled']} requests compared)", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
