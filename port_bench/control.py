#!/usr/bin/env python3
"""The readings that the limits of ``correct`` are set from, on the card.

    python3 port_bench/control.py --workload <cell> --seeds S1 S2 ... \
        --control-seeds C1 C2 C3 [--seconds 2]

For each of ``--seeds`` it runs the cell as the benchmark does (set-up, a
short window of ``--seconds`` at the cell's own load, the check against
the reference) and prints the numbers compared: the lower readings.  For
each of ``--control-seeds`` it puts the controls in the program's place
on a seeded sample of the cell's request images, against the same float32
reference:

* ``fp8``: the reference itself with fp8 (e4m3, one scale per tensor)
  operands in every convolution and product, the bank and threshold
  worked out again in fp8: the precision below the configuration's bf16;
* ``int8``: the port's own int8 weight path (``export --dtype int8``:
  per-channel int8 weights served as bf16 values, the bank embedded with
  the full weights).

One JSON line per reading, then a summary: per number, the largest
program reading and the smallest of each control.  The benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def sample_pool(tr: dict, seed: int) -> np.ndarray:
    from port_bench.core import seeded

    rng = np.random.default_rng(seeded.stream(seed, "control-sample"))
    n, pool = tr["sample"], tr["pool_images"]
    return np.sort(rng.choice(pool, size=n, replace=n > pool))


def direct_outputs(scorer, images: np.ndarray, mode: str, threshold: float, batch: int) -> dict:
    """The scorer's outputs for ``images``, ``batch`` at a time, in the
    driver's ``program_outputs`` form."""
    import torch

    parts = [scorer(images[lo:lo + batch]) for lo in range(0, images.shape[0], batch)]
    cols = [np.concatenate(c) for c in zip(*parts)]
    if mode == "patch":
        return {"maps": torch.from_numpy(cols[0]).double()}
    return {"scores": torch.from_numpy(cols[0]).double(),
            "labels": torch.from_numpy(cols[1] > 0),
            "logits": torch.from_numpy(cols[2]).double(), "threshold": threshold}


def control_readings(cell, seed: int, device) -> dict:
    """{control: numbers} for one seed."""
    from port_bench.core import manifest, seeded
    from port_bench.reference import peranet as ref_net

    drv = manifest.driver(cell.traffic["driver"])
    cfg, tr = cell.config, cell.traffic
    picks = sample_pool(tr, seed)
    band = cell.limits.get("score_gap", 0.0)
    reference = drv.reference_outputs(cfg, tr, seed, device, picks, flip_band=band)
    fp8 = drv.reference_outputs(cfg, tr, seed, device, picks, precision=ref_net.Fp8())
    out = {"fp8": drv.compare(tr["mode"], fp8, reference)}
    del fp8
    state = seeded.fill_state(drv.shapes(cfg), seed, device)
    scorer, _, threshold = drv.build_scorer(cfg, tr, state, seed, device, weights_dtype="int8")
    images = seeded.images(tr["pool_images"], tr["imsize"], seed, "requests", device)
    images = images.cpu().numpy()[picks]
    int8 = direct_outputs(scorer, images, tr["mode"], threshold, tr["batch"])
    out["int8"] = drv.compare(tr["mode"], int8, reference)
    del scorer, state
    drv.free(device)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)

    from port_bench.core import device as dev
    from port_bench.core import manifest

    cell = manifest.resolve_cell(args.workload)
    device = dev.require_cards(cell.chips)
    drv = manifest.driver(cell.traffic["driver"])
    program, controls = [], {}
    for seed in args.seeds:
        t0 = time.perf_counter()
        res = drv.run(cell, seed, args.seconds, False, device)
        drv.free(device)
        program.append(res["numbers"])
        print(json.dumps({"kind": "program", "seed": seed, "numbers": res["numbers"],
                          "sampled": res["sampled"], "s": time.perf_counter() - t0}), flush=True)
    for seed in args.control_seeds:
        t0 = time.perf_counter()
        for kind, numbers in control_readings(cell, seed, device).items():
            controls.setdefault(kind, []).append(numbers)
            print(json.dumps({"kind": kind, "seed": seed, "numbers": numbers,
                              "s": time.perf_counter() - t0}), flush=True)
    names = sorted({n for r in program + sum(controls.values(), []) for n in r})
    summary = {n: {"program_max": max((r[n] for r in program), default=None),
                   **{f"{k}_min": min(r[n] for r in rs) for k, rs in controls.items()}}
               for n in names}
    print(json.dumps({"kind": "summary", "workload": args.workload, "limits": cell.limits,
                      "readings": summary, "card": dev.record(device, 1, 0)["kind"],
                      "power_limit": dev.power_limit()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
