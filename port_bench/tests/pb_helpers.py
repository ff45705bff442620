"""Tiny CPU cells for the harness's tests: the real mixes' parameters at
small sizes, added to a copy of the manifest as a later change adds one."""

import json
import shutil
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]

#: tiny traffic for the CPU: the real mixes' parameters at small sizes
TINY = {
    "patch": dict(imsize=96, batch=2, clients=3, normality_images=19, normality_batch=4,
                  pool_images=6, sample=4),
    "image": dict(imsize=64, batch=4, clients=6, normality_images=40, normality_batch=8,
                  pool_images=16, sample=16),
}
REAL = {"patch": ("patch_closed16", "r18_patch_serve"),
        "image": ("image_closed128", "r18_image_serve")}


def add_tiny_cell(root: Path, mode: str, name: str = None) -> str:
    """Copy the manifest and the configuration files into ``root`` and add
    one cell at a tiny size: one traffic file, one cell file (the real
    cell's limits) and one manifest entry.  Returns the cell's name."""
    name = name or f"tiny_{mode}"
    traffic_name, real_cell = REAL[mode]
    bench = root / "port_bench"
    for sub in ("configs", "traffic", "workloads"):
        (bench / sub).mkdir(parents=True, exist_ok=True)
    manifest_path = root / "BENCHMARK.json"
    if not manifest_path.exists():
        shutil.copy(ROOT / "BENCHMARK.json", manifest_path)
        for f in (ROOT / "port_bench" / "configs").glob("*.json"):
            shutil.copy(f, bench / "configs" / f.name)
    manifest = json.loads(manifest_path.read_text())
    manifest["workloads"].append({"name": name, "config": "peranet_r18", "traffic": name,
                                  "chips": 1, "why": "a tiny CPU cell of the harness tests"})
    for group in ("end_to_end", "per_layer"):
        for m in manifest[group]:
            if real_cell in m.get("workloads", []):
                m["workloads"].append(name)
    manifest_path.write_text(json.dumps(manifest))
    traffic = json.loads((ROOT / "port_bench" / "traffic" / f"{traffic_name}.json").read_text())
    traffic.update(TINY[mode])
    (bench / "traffic" / f"{name}.json").write_text(json.dumps(traffic))
    shutil.copy(ROOT / "port_bench" / "workloads" / f"{real_cell}.json",
                bench / "workloads" / f"{name}.json")
    return name


def run_cell(root: Path, cell: str, seed: int = 2**31 + 11, seconds: float = 1.0,
             trace: int = 0, capsys=None):
    """run.main on the CPU → (exit code, the result line or None)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("pb_run", ROOT / "port_bench" / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                   "--trace", str(trace)], device=torch.device("cpu"), root=root)
    line = None
    if capsys is not None:
        out = capsys.readouterr().out.strip().splitlines()
        line = json.loads(out[-1]) if out else None
    return rc, line
