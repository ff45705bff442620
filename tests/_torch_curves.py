"""Do the JAX package's and the port's pixel-metric curves fall, on the CPU?

    python tests/_torch_curves.py [--seeds 200]

The sweep of scripts/torch_curve_sweep.py (tests/test_metrics_device.py's
problem at ``default_rng(s)`` for s < ``--seeds``, held to that test's rule
by ``_torch_card_fixtures.curve_faults``), run by both packages' ``pixel_metrics``
on the CPU.  Prints one JSON line per package; the port's carries the
largest |AUPRO - JAX's| over the problems.  It imports both packages, so
it lives with the tests.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import _torch_card_fixtures as fx  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=fx.CURVE_SEEDS)
    args = ap.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    from ssad_tpu.evaluation import metrics_device as JMD
    from ssad_tpu_torch.evaluation import metrics_device as MD

    seeds = range(args.seeds)
    ref = fx.curve_sweep(JMD.pixel_metrics, seeds)
    port = fx.curve_sweep(MD.pixel_metrics, seeds)
    ref_aupro, port_aupro = ref.pop("aupro"), port.pop("aupro")
    print(json.dumps({"package": "ssad_tpu", "device": "cpu", **ref}), flush=True)
    port["largest_aupro_gap_to_jax"] = max(abs(port_aupro[s] - ref_aupro[s]) for s in seeds)
    print(json.dumps({"package": "ssad_tpu_torch", "device": "cpu", **port}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
