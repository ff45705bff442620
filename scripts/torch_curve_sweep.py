#!/usr/bin/env python3
"""Do the port's pixel-metric curves fall anywhere?  A sweep over 200 problems.

    python3 scripts/torch_curve_sweep.py                  # the CPU
    python3 scripts/torch_curve_sweep.py --device cuda    # a card

Each problem is tests/test_metrics_device.py's (6 × 64 × 64 blob masks and
correlated scores, ``default_rng(s)`` for s < ``--seeds``, rebuilt by
``tests/_torch_card_fixtures.py``'s ``curve_problem``), and the port's ``pixel_metrics``, its maps
on ``--device``, is held to that test's rule on its plotted curves
(``curve_faults``: every step of x and y ≥ -1e-7 on the ROC and
the PRO curve, y in [0, 1 + 1e-6], the ROC's trapezoid within 5e-3 of the
AUROC).  Prints one JSON line: the problems, the seeds whose curves fall at
all (``dipped``), the largest fall, the seeds that break the rule
(``failed``); on a card with its ``nvidia-smi`` name and power limit.
Exits 1 when any problem breaks the rule.  The JAX package's count on the
same problems, beside the port's on the CPU: ``python tests/_torch_curves.py``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import _torch_card_fixtures as fx  # noqa: E402
import chip_smoke  # noqa: E402  (this checkout's root on sys.path first)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cpu", choices=["cpu", "cuda"])
    ap.add_argument("--seeds", type=int, default=fx.CURVE_SEEDS)
    args = ap.parse_args()
    import torch

    from ssad_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    port = fx.curve_sweep(fx.on_device_pixel_metrics(device), range(args.seeds))
    port.pop("aupro")
    port.update(package="ssad_tpu_torch", device=str(device), torch=torch.__version__)
    if device.type == "cuda":
        port["card"] = chip_smoke.card_line()
    print(json.dumps(port), flush=True)
    return 1 if port["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
