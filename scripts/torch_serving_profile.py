#!/usr/bin/env python3
"""Device-time breakdown of the port's serving paths on a card.

Run from the repository root on a machine with one CUDA card:

    python3 scripts/torch_serving_profile.py [--mode image|patch|both]

Builds the full-width scorers of chip_smoke.py (PeraNet/ResNet-18, 256²,
bf16 backbone, seeded weights, k = 3, batch 8) and traces them with
torch.profiler:

* image mode (a 700-row f32 bank):
  * ``knn``: device time per call of the resident k-NN kernel at the
    serving shape (8 × 700 × 512) and the fit shape (300 × 700 × 512),
    beside the host-clock time per call;
  * ``served_batch``: one batch-8 ``ServedScorer`` call — wall time,
    device busy time, idle share, and device time by group (k-NN kernel,
    copies, the rest = the model) with the top kernels by time;
* patch mode (a 29,435-row f32 bank, 6,728 windows per batch):
  * ``kernels``: device time per call of the stem kernel at N = 6728 and
    of the tiled k-NN kernel (its two kernels summed) at 6728 × 29435,
    against the bank's TiledBank (split once, as served) and against the
    raw bank (normalised and split on every call);
  * ``served_batch``: as above, with the groups stem kernel, tiled k-NN
    kernel, copies, and the rest (the backbone, head, the queries'
    normalise/split and the blur ⊗ upsample products), and the count of
    host-side ops per call that take a bank-sized (29,435-row) tensor:
    0 when the scorer holds the split bank.

Prints one JSON line per section and the card's name and power limit.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (repo root on sys.path first)


def group(name: str) -> str:
    if "stem_pool" in name:
        return "stem_kernel"
    if "knn_tiled" in name:
        return "knn_tiled_kernel"
    if "knn_" in name:
        return "knn_kernel"
    if "Memcpy" in name or "memcpy" in name:
        return "copies"
    return "model"


def profile(fn, calls: int, rows: int = 0):
    """Trace ``calls`` calls of fn after a warmup; returns (events, wall_ms
    per call, host-side ops per call with an input of ``rows`` rows)."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                  record_shapes=bool(rows)) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    sized = sum(
        1 for e in prof.events()
        if rows and e.device_type == torch.autograd.DeviceType.CPU
        and any(s and s[0] == rows for s in (e.input_shapes or []))
    )
    return chip_smoke.device_events(prof), wall_ms, sized / calls


def breakdown(scorer, x, calls: int, section: dict, rows: int = 0) -> None:
    """Trace ``calls`` scorer calls and print the device-time groups."""
    events, wall_ms, _ = profile(lambda: scorer(x), calls)
    sized = profile(lambda: scorer(x), 1, rows)[2] if rows else 0  # shapes cost host time
    by_group, by_name = {}, {}
    for name, s, e in events:
        by_group[group(name)] = by_group.get(group(name), 0.0) + (e - s) / calls
        by_name[name] = by_name.get(name, 0.0) + (e - s) / calls
    busy = chip_smoke.busy_us(events) / calls
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    print(json.dumps({
        **section, "section": "served_batch", "batch": chip_smoke.BATCH, "calls": calls,
        "wall_ms_per_call": wall_ms, "device_busy_us_per_call": busy,
        "idle_share": 1.0 - busy / (wall_ms * 1e3) if events else None,
        "device_us_by_group": by_group,
        "top_kernels_us": [[name[:80], us] for name, us in top],
        "device_events_per_call": len(events) / calls,
        **({"bank_sized_ops_per_call": sized} if rows else {}),
    }), flush=True)


def image_mode(device) -> None:
    import torch

    from ssad_tpu_torch.config import ModelConfig
    from ssad_tpu_torch.ops import knn
    from ssad_tpu_torch.serving.export import ServedScorer

    gen = torch.Generator(device=device).manual_seed(0)
    for label, n in (("serve", 8), ("fit", 300)):
        q = torch.randn((n, 512), generator=gen, device=device)
        b = torch.randn((700, 512), generator=gen, device=device)
        calls = 200
        events, wall_ms, _ = profile(lambda: knn.knn_cosine_scores_cuda(q, b, k=3), calls)
        kern = [e for e in events if "knn_" in e[0]]
        print(json.dumps({"section": "knn", "shape": [n, 700, 512], "k": 3,
                          "device_events": len(kern),
                          "device_us_per_call": sum(e - s for _, s, e in kern) / calls,
                          "host_ms_per_call": wall_ms}), flush=True)

    rng = np.random.default_rng(0)
    bank = torch.from_numpy(rng.standard_normal((700, 512)).astype(np.float32))
    meta = {"mode": "image", "model": dataclasses.asdict(ModelConfig()), "k": 3,
            "threshold": 0.5, "batch": chip_smoke.BATCH, "imsize": [chip_smoke.IMSIZE] * 2}
    scorer = ServedScorer(meta, chip_smoke.reference_state_dict(0), bank, device)
    breakdown(scorer, chip_smoke.synthetic_images(rng, chip_smoke.BATCH), 20, {"mode": "image"})


def patch_mode(device) -> None:
    import torch

    from ssad_tpu_torch.config import ModelConfig
    from ssad_tpu_torch.ops import knn, stem_pool
    from ssad_tpu_torch.serving.export import ServedScorer

    n = chip_smoke.BATCH * chip_smoke.WINDOWS
    m = 29435  # 50 images x 841 windows, after the 70/30 fit
    gen = torch.Generator(device=device).manual_seed(0)
    x = (2 * torch.rand((n, 32, 32, 3), generator=gen, device=device) - 1).to(torch.bfloat16)
    k4 = 0.3 * torch.randn((4, 4, 3, 64), generator=gen, device=device)
    scale, bias = torch.ones(64, device=device), torch.zeros(64, device=device)
    q = torch.randn((n, 512), generator=gen, device=device)
    b = torch.randn((m, 512), generator=gen, device=device)
    prepared = knn.prepare_tiled_bank(b)
    for name, fn, key, shape in (
        ("stem_pool", lambda: stem_pool.stem_pool_cuda(x, k4, scale, bias), "stem_pool",
         [n, 32, 32, 3]),
        ("knn_cosine_scores_tiled", lambda: knn.knn_cosine_scores_tiled_cuda(q, prepared, k=3),
         "knn_tiled", [n, m, 512]),
        ("knn_cosine_scores_tiled_raw_bank", lambda: knn.knn_cosine_scores_tiled_cuda(q, b, k=3),
         "knn_tiled", [n, m, 512]),
    ):
        calls = 20
        events, wall_ms, _ = profile(fn, calls)
        kern = [e for e in events if key in e[0]]
        print(json.dumps({"section": "kernels", "mode": "patch", "kernel": name,
                          "shape": shape, "device_events": len(kern),
                          "device_us_per_call": sum(e - s for _, s, e in kern) / calls,
                          "device_us_all_ops_per_call": sum(e - s for _, s, e in events) / calls,
                          "host_ms_per_call": wall_ms}), flush=True)

    rng = np.random.default_rng(0)
    bank = torch.from_numpy(rng.standard_normal((m, 512)).astype(np.float32))
    meta = {"mode": "patch", "model": dataclasses.asdict(ModelConfig()), "k": 3,
            "threshold": 0.5, "batch": chip_smoke.BATCH, "imsize": [chip_smoke.IMSIZE] * 2,
            "patch_dim": 32, "stride": 8, "upsample_to": chip_smoke.IMSIZE}
    scorer = ServedScorer(meta, chip_smoke.reference_state_dict(0), bank, device)
    breakdown(scorer, chip_smoke.synthetic_images(rng, chip_smoke.BATCH), 5,
              {"mode": "patch", "patches": n, "bank_rows": m}, rows=m)


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--mode", default="both", choices=["image", "patch", "both"])
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_serving_profile: needs a CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {chip_smoke.card_line()}", flush=True)
    if args.mode in ("image", "both"):
        image_mode(device)
    if args.mode in ("patch", "both"):
        patch_mode(device)
    print(f"card: {chip_smoke.card_line()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
