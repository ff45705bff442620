#!/usr/bin/env python3
"""Which convolutions and dots does a TPU program of the JAX package run,
on which operand and result types and at which precision?

    python3 scripts/tpu_precision_census.py [--out outputs/tpu_census]
        [--topologies v4:2x2x1,v5e:2x2]

No TPU is needed: ``libtpu`` compiles for a TPU topology with none attached
(``jax.experimental.topologies.get_topology_desc``, then
``jit(f).lower(<ShapeDtypeStructs on one of its devices>).compile()``),
and the optimized HLO is read from ``.as_text()``.  It imports the JAX
package the way its tests do (the repository root on ``sys.path``) and
compiles, for each topology:

* ``train bottle`` / ``train hazelnut``: the image-level fine-tune
  ``train_step`` of ``ssad_tpu.train.trainer.Trainer`` (synthesis of a
  fixed-pose and of a non-fixed subject, bf16 forward and backward, SGD,
  bank fill) at 256², batch 96, the parity run's shapes (32 train images,
  15 cut images);
* ``eval forward``: ``PeraNet.apply(train=False)`` in bf16 at 256², batch 96;
* ``patch forward``: the same on one image's 841 windows of 32×32, the TPU
  patch path's default (its folded stem; the Pallas stem is opt-in there);
* ``synth bottle`` / ``synth hazelnut``: ``batched_synthesizer`` alone at
  256², batch 96.

Every convolution and dot of the optimized HLO (a TPU program lowers a dot
to a ``convolution`` whose ``op_name`` ends in ``dot_general``) is listed
with its operand types, result type, ``operand_precision`` (absent:
DEFAULT, which a TPU runs as one bf16 pass for f32 operands) and its source:
the innermost frame of its stack in the JAX package.  An f32 dot at
DEFAULT precision is flagged with the port's counterpart and the type the
port's source declares for it (``port_declared``: read from the table
``PORT`` below, not measured here; tests/test_torch_tpu_one_pass.py
measures the port's head and bank insert against the JAX program with and
without the TPU's roundings).  Writes ``census.json`` under ``--out`` and prints one
JSON line per program and a summary line.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

IMSIZE, BATCH, N_TRAIN, N_VAL, N_CUT, N_WINDOWS = 256, 96, 32, 8, 15, 841

#: where the port computes what a JAX source file computes, and the type its
#: source declares for it (the port's synthesis and the PeraNet head run in
#: f32; PyTorch's matmuls keep TF32 off unless asked): declared, not measured
PORT = {
    "ssad_tpu/ops/rasterize.py": ("ssad_tpu_torch/ops/rasterize.py", "f32"),
    "ssad_tpu/data/synthetic.py": ("ssad_tpu_torch/data/synthetic.py", "f32"),
    "ssad_tpu/ops/image.py": ("ssad_tpu_torch/ops/image.py", "f32"),
    "ssad_tpu/models/peranet.py": ("ssad_tpu_torch/models/peranet.py", "f32"),
    "ssad_tpu/train/trainer.py": ("ssad_tpu_torch/train/trainer.py", "f32"),
    "ssad_tpu/train/memory_bank.py": ("ssad_tpu_torch/train/memory_bank.py", "f32"),
}

_INSTR = re.compile(r"^\s*(?:ROOT )?%?(\S+) = (\S+?)(?:\{[^}]*\})? ([\w-]+)\((.*?)\)(.*)$")


def _frames(text: str):
    """The HLO text's FileNames / FunctionNames / FileLocations /
    StackFrames tables → frame id → [(file, function, line), ...] innermost
    first."""
    tables, name = {}, None
    for line in text.splitlines():
        if line in ("FileNames", "FunctionNames", "FileLocations", "StackFrames"):
            name, tables[line] = line, {}
        elif name and line.strip():
            i, rest = line.split(" ", 1)
            tables[name][int(i)] = rest
        elif name:
            name = None
    files = {i: v.strip('"') for i, v in tables.get("FileNames", {}).items()}
    funcs = {i: v.strip('"') for i, v in tables.get("FunctionNames", {}).items()}
    locs = {}
    for i, v in tables.get("FileLocations", {}).items():
        f = dict(re.findall(r"(\w+)=(\d+)", v))
        locs[i] = (files[int(f["file_name_id"])], funcs[int(f["function_name_id"])],
                   int(f["line"]))
    parents = {}
    for i, v in tables.get("StackFrames", {}).items():
        f = dict(re.findall(r"(\w+)=(\d+)", v))
        parents[i] = (int(f["file_location_id"]), int(f["parent_frame_id"]) - 1)

    def stack(i):
        out = []
        while i in parents and len(out) < 64:
            loc, parent = parents[i]
            out.append(locs[loc])
            i = parent
        return out

    return stack


def _repo_frame(stack):
    """The innermost frame in the JAX package: (file:line, file, function)."""
    for file, func, line in stack:
        p = Path(file)
        if "ssad_tpu" in p.parts and "site-packages" not in p.parts:
            rel = Path(*p.parts[p.parts.index("ssad_tpu"):])
            return f"{rel}:{line}", str(rel), func
    return None, None, None


def census(text: str) -> list:
    """Every dot and convolution of an HLO text (declared or optimized):
    kind, operand and result types, precision, source."""
    stack = _frames(text)
    types, ops = {}, []
    for line in text.splitlines():
        m = _INSTR.match(line)
        if not m:
            continue
        name, rtype, opcode, operands, attrs = m.groups()
        types[name] = rtype
        if opcode in ("convolution", "dot"):
            ops.append((name, rtype, opcode, operands, attrs))
    out = []
    for name, rtype, opcode, operands, attrs in ops:
        args = [a.strip().lstrip("%") for a in operands.split(",")]
        op_name = re.search(r'op_name="([^"]*)"', attrs)
        frame = re.search(r"stack_frame_id=(\d+)", attrs)
        prec = re.search(r"operand_precision=\{([^}]*)\}", attrs)
        src, file, func = _repo_frame(stack(int(frame.group(1))) if frame else [])
        op = op_name.group(1) if op_name else ""
        # a TPU program lowers a dot to a convolution named after the dot
        kind = "dot" if opcode == "dot" or op.endswith("dot_general") else "conv"
        out.append({"kind": kind, "operands": [types.get(a, "?").split("[")[0] for a in args],
                    "result": rtype.split("[")[0], "shape": rtype.split("{")[0],
                    "precision": prec.group(1).replace(" ", "") if prec else "default",
                    "source": src, "file": file, "function": func})
    return out


def _types(o) -> str:
    return f"{'x'.join(o['operands'])}->{o['result']}"


def flag(declared: list, compiled: list) -> dict:
    """The declared f32 dots at DEFAULT precision, by source line: the
    shapes, what the TPU program made of them (operand and result types
    of the optimized ops from that line) and the port's counterpart."""
    flagged = {}
    for o in declared:
        if o["kind"] == "dot" and o["operands"] == ["f32", "f32"] and \
                set(o["precision"].split(",")) <= {"default"}:
            port = PORT.get(o["file"])
            f = flagged.setdefault(o["source"], {
                "function": o["function"], "declared": Counter(), "on_tpu": Counter(),
                "port_declared": {"file": port[0], "computes_in": port[1]} if port else None})
            f["declared"][o["shape"]] += 1
    for o in compiled:
        if o["source"] in flagged:
            flagged[o["source"]]["on_tpu"][f"{o['kind']} {_types(o)} {o['precision']}"] += 1
    return {k: {**v, "declared": dict(v["declared"]), "on_tpu": dict(v["on_tpu"])}
            for k, v in flagged.items()}


def programs():
    """name → (jitted function, a function of a sharding giving its abstract arguments)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ssad_tpu.config import DataConfig, ModelConfig, TrainConfig
    from ssad_tpu.data.mvtec import PretextData
    from ssad_tpu.data.synthetic import SynthSpec, batched_synthesizer
    from ssad_tpu.models.peranet import build_model, init_model
    from ssad_tpu.train import trainer as jtrainer

    def sds(a, sh):
        return jax.ShapeDtypeStruct(np.shape(a), getattr(a, "dtype", np.asarray(a).dtype),
                                    sharding=sh)

    def data(subject):
        hw = (IMSIZE, IMSIZE)
        d = dict(subject=subject, imsize=hw,
                 train_images=np.zeros((N_TRAIN, *hw, 3), np.float32),
                 val_images=np.zeros((N_VAL, *hw, 3), np.float32),
                 cut_pool=np.zeros((N_CUT, *hw, 3), np.float32),
                 fixed_mask=np.zeros(hw, np.float32),
                 fixed_coords=np.zeros((IMSIZE * IMSIZE, 2), np.int32), fixed_count=1)
        if subject == "hazelnut":
            for split, n in (("train", N_TRAIN), ("val", N_VAL)):
                d[f"{split}_masks"] = np.zeros((n, *hw), np.float32)
                d[f"{split}_coords"] = np.zeros((n, IMSIZE * IMSIZE, 2), np.int32)
                d[f"{split}_counts"] = np.ones((n,), np.int32)
        return PretextData(**d)

    model = build_model(ModelConfig())
    variables = jax.eval_shape(
        lambda k: init_model(model, k, (1, IMSIZE, IMSIZE, 3)), jax.random.key(0))
    key_type = jax.eval_shape(lambda: jax.random.key(0))

    def train(subject):
        cfg = TrainConfig(data=DataConfig(subject=subject, imsize=(IMSIZE, IMSIZE),
                                          batch_size=BATCH))
        tr = jtrainer.Trainer(cfg, data(subject))
        tr._params_template = variables[0]
        step, _, tx, _ = tr._get_step_fns("fine_tune")
        m = cfg.model
        from ssad_tpu.train.memory_bank import init_bank

        state = jax.eval_shape(lambda p, s: jtrainer.TrainState(
            p, s, tx.init(p), init_bank(m.memory_bank_size, m.latent_dim),
            jnp.zeros((), jnp.int32)), *variables)
        arrays = tr._device_data("train")

        def args(sh):
            return (jax.tree_util.tree_map(lambda a: sds(a, sh), state), sds(key_type, sh),
                    *(sds(a, sh) for a in arrays), sds(jnp.bool_(True), sh))

        return step, args

    def forward(shape):
        fn = jax.jit(lambda v, x: model.apply(v, x, train=False))

        def args(sh):
            v = {"params": variables[0], "batch_stats": variables[1]}
            return (jax.tree_util.tree_map(lambda a: sds(a, sh), v),
                    jax.ShapeDtypeStruct(shape, jnp.float32, sharding=sh))

        return fn, args

    def synth(subject):
        per_image = subject == "hazelnut"
        spec = SynthSpec(subject=subject, imsize=(IMSIZE, IMSIZE))
        fn = jax.jit(batched_synthesizer(spec, per_image_masks=per_image))
        hw = (IMSIZE, IMSIZE)
        lead = (BATCH,) if per_image else ()

        def args(sh):
            S = lambda shape, dt: jax.ShapeDtypeStruct(shape, dt, sharding=sh)  # noqa: E731
            return (jax.ShapeDtypeStruct((BATCH,), key_type.dtype, sharding=sh),
                    S((BATCH, *hw, 3), jnp.float32), S((N_CUT, *hw, 3), jnp.float32),
                    S((), jnp.int32), S((*lead, *hw), jnp.float32),
                    S((*lead, IMSIZE * IMSIZE, 2), jnp.int32), S(lead, jnp.int32))

        return fn, args

    return {
        "train bottle": lambda: train("bottle"),
        "train hazelnut": lambda: train("hazelnut"),
        "eval forward": lambda: forward((BATCH, IMSIZE, IMSIZE, 3)),
        "patch forward": lambda: forward((N_WINDOWS, 32, 32, 3)),
        "synth bottle": lambda: synth("bottle"),
        "synth hazelnut": lambda: synth("hazelnut"),
    }


def by_types(ops: list) -> dict:
    return dict(sorted(Counter(f"{o['kind']} {_types(o)} {o['precision']}" for o in ops).items()))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="outputs/tpu_census")
    ap.add_argument("--topologies", default="v4:2x2x1,v5e:2x2")
    ap.add_argument("--programs", default=None, help="comma-separated subset")
    args = ap.parse_args()
    import jax
    from jax.experimental import topologies
    from jax.sharding import SingleDeviceSharding

    import libtpu  # noqa: F401  (the compiler; no TPU needs to be attached)

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    progs = programs()
    names = args.programs.split(",") if args.programs else list(progs)
    t0 = time.perf_counter()
    result = {"jax": jax.__version__, "libtpu": getattr(libtpu, "__version__", None),
              "imsize": IMSIZE, "batch": BATCH, "topologies": {}}
    for topo_name in args.topologies.split(","):
        topo = topologies.get_topology_desc(platform="tpu", topology_name=topo_name)
        dev = topo.devices[0]
        sh = SingleDeviceSharding(dev)
        per = result["topologies"][topo_name] = {"device_kind": dev.device_kind, "programs": {}}
        for name in names:
            t = time.perf_counter()
            fn, build = progs[name]()
            lowered = fn.lower(*build(sh))
            declared = census(lowered.as_text(dialect="hlo", debug_info=True))
            ops = census(lowered.compile().as_text())
            rec = {"declared": by_types(declared), "on_tpu": by_types(ops),
                   "f32_default_dots": flag(declared, ops),
                   "compile_s": time.perf_counter() - t, "ops": ops}
            per["programs"][name] = rec
            line = {k: v for k, v in rec.items() if k != "ops"}
            print(json.dumps({"topology": topo_name, "program": name, **line}), flush=True)
    flagged = {}
    for topo_name, per in result["topologies"].items():
        for name, rec in per["programs"].items():
            for src, f in rec["f32_default_dots"].items():
                g = flagged.setdefault(src, {"function": f["function"],
                                             "port_declared": f["port_declared"],
                                             "programs": set(), "on_tpu": Counter()})
                g["programs"].add(name)
                g["on_tpu"].update(f["on_tpu"])
    result["f32_default_dots"] = {k: {**v, "programs": sorted(v["programs"]),
                                      "on_tpu": dict(v["on_tpu"])}
                                  for k, v in sorted(flagged.items())}
    result["bf16_conv_results"] = {
        f"{t} {n}": sum(1 for o in r["ops"] if o["kind"] == "conv" and o["result"] == "bf16")
        for t, per in result["topologies"].items() for n, r in per["programs"].items()}
    result["f32_conv_results"] = {
        f"{t} {n}": sum(1 for o in r["ops"] if o["kind"] == "conv" and o["result"] == "f32")
        for t, per in result["topologies"].items() for n, r in per["programs"].items()}
    result["wall_s"] = time.perf_counter() - t0
    (out / "census.json").write_text(json.dumps(result, indent=1))
    print(json.dumps({k: result[k] for k in ("f32_default_dots", "bf16_conv_results",
                                             "f32_conv_results", "wall_s")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
