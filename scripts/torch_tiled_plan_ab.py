#!/usr/bin/env python3
"""The streaming k-NN kernel's split count, A/B on a card.

Run from the repository root on a machine with one CUDA card:

    python3 scripts/torch_tiled_plan_ab.py

At the patch path's request shape (6728 queries × 29,435 bank rows × 512,
k = 3, the bank as a TiledBank) it runs csrc/knn_tiled.cu under two
launch plans and prints each one's device µs per call (profiler), in the
order A, B, B, A:

* A, ``ops.knn._tiled_plan``: of all split counts, the earliest finish
  when CTAs go to the SMs in launch order (the last split shorter);
* B, a closed-form rule: the fewest splits that give at least one full
  wave at one CTA per SM with under 10 % of the waves' CTA slots empty.

Both plans must give the same bits.  Ends with the card's name and power
limit.  Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (repo root on sys.path first)

N, M, D, K = chip_smoke.BATCH * chip_smoke.WINDOWS, 29435, 512, 3


def closed_form_plan(knn, n: int, m: int, sms: int):
    q_tiles, m_tiles = -(-n // knn._TILE_Q), -(-m // knn._TILE_M)
    for per_split in sorted({-(-m_tiles // s) for s in range(1, m_tiles + 1)}, reverse=True):
        ctas = q_tiles * -(-m_tiles // per_split)
        waves = -(-ctas // sms)
        if ctas >= sms and ctas / (waves * sms) > 0.9:
            break
    return knn.TiledPlan(q_tiles, m_tiles, per_split, -(-m_tiles // per_split))


def main() -> int:
    import torch

    from ssad_tpu_torch.ops import knn
    from ssad_tpu_torch.utils.device import resolve_device

    device = resolve_device(None)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    gen = torch.Generator(device=device).manual_seed(0)
    q = torch.randn((N, D), generator=gen, device=device)
    bank = knn.prepare_tiled_bank(torch.randn((M, D), generator=gen, device=device))
    simulated = knn._tiled_plan
    plans = {"A": simulated(N, M, D, sms), "B": closed_form_plan(knn, N, M, sms)}

    def scores(name):
        knn._tiled_plan = lambda *args: plans[name]
        try:
            out = knn.knn_cosine_scores_tiled_cuda(q, bank, k=K)
            torch.cuda.synchronize()
            return out
        finally:
            knn._tiled_plan = simulated

    if not torch.equal(scores("A"), scores("B")):
        chip_smoke.fail("the two plans' scores differ")
    for name in ("A", "B", "B", "A"):
        knn._tiled_plan = lambda *args, name=name: plans[name]
        try:
            us = chip_smoke.device_us(lambda: knn.knn_cosine_scores_tiled_cuda(q, bank, k=K),
                                      "knn_tiled", 20)
        finally:
            knn._tiled_plan = simulated
        print(json.dumps({"plan": name, **plans[name]._asdict(), "shape": [N, M, D], "k": K,
                          "device_us": us}), flush=True)
    print(chip_smoke.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
