"""Shared parts of the bf16 parity tests (tests/test_torch_bf16_layers.py,
tests/test_torch_train_step_bf16.py): one module of each package on the
same bf16 input, parameters and cotangent, the port's run under the JAX
module's ReLU / max-pool decisions and layer inputs (``Pinned`` with
``teacher``), and the readings that are compared.

The JAX side runs jitted with XLA's excess precision off
(``_torch_train.DECLARED_PRECISION``): every value the JAX source
declares bf16 is rounded, as op-by-op JAX does.  At its default the CPU
program keeps a bf16 convolution's f32 accumulation where the BatchNorm
reads it; the port follows the source's dtypes, as cuDNN's bf16
convolution computes them.

Run as a script, it prints the readings behind the limits of both test
files (the layers over seeds 0–2, the pinned step over seeds 1–3) and the
unpinned spread of the fine-tune step's logits over seeds 1–12, in both
packages and both dtypes:

    python tests/_torch_bf16.py layers|step|spread
    python tests/_torch_bf16.py spread default   # the bf16 JAX step at XLA's default
    python tests/_torch_bf16.py forward-spread 256   # the forward at another size

``forward-spread SIZE`` reads the train-mode forward's logits from each
of seeds 0–3's JAX init on a normal batch of 8 at SIZE², both packages,
both dtypes, and the bf16 JAX forward with the TPU's own roundings
(``_torch_train.tpu_one_pass``), as the largest |Δlogit| per pair.

and saves, then compares, the port's pinned-step gradients (the JAX
decisions cached in DIR, so two CPU settings differ only in the port's
own summation order):

    python tests/_torch_bf16.py grads OUT.npz DIR
    python tests/_torch_bf16.py compare A.npz B.npz
"""

import sys

import _torch_pinning as pn
import _torch_step_parity as sp
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.nn.functional as F

from _torch_train import block_decisions, declared_jit

from ssad_tpu.models import resnet as jr
from ssad_tpu.models.peranet import PeraNet as JPeraNet
from ssad_tpu_torch.models import resnet as pr
from ssad_tpu_torch.models.peranet import PeraNet
from ssad_tpu_torch.utils.jax_bridge import _conv, _t, state_dict_from_jax

torch.set_num_threads(1)
BF = jnp.bfloat16
BATCH = 8


def to_torch(a) -> torch.Tensor:
    """A JAX array as a tensor of its dtype; bf16 goes through f32, which
    is exact."""
    if a.dtype == BF:
        return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def nchw(a) -> torch.Tensor:
    return to_torch(a).permute(0, 3, 1, 2).contiguous()


class JStem(fnn.Module):
    """The JAX ResNet's stem as ``ResNet.__call__`` runs it
    (ssad_tpu/models/resnet.py): ``StemConv`` (7×7/s2, or the folded
    4×4/s1), ``bn1``, ReLU, the 3×3/s2 max-pool."""

    fold: bool = False

    @fnn.compact
    def __call__(self, x, train: bool = True):
        x = jr.StemConv(features=64, dtype=BF, name="conv1")(x.astype(BF), fold_2x=self.fold)
        x = fnn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=BF, name="bn1")(
            x, use_running_average=not train)
        x = fnn.relu(x)
        return fnn.max_pool(x, (3, 3), strides=(2, 2), padding=[(1, 1), (1, 1)])


class PortStem(torch.nn.Module):
    """The port's stem: ``ResNet.forward`` of a stage-less ResNet, which
    returns the max-pool's output."""

    def __init__(self, fold: bool = False):
        super().__init__()
        self.fold = fold
        self.net = pr.ResNet(stage_sizes=(), dtype=torch.bfloat16)
        self.net.forward_stages = lambda x: (x, {})

    def forward(self, x):
        return self.net(x.permute(0, 3, 1, 2), stem_fold_2x=self.fold)[0]


def _bn(prefix, p, s):
    return {f"{prefix}.weight": _t(p["scale"]), f"{prefix}.bias": _t(p["bias"]),
            f"{prefix}.running_mean": _t(s["mean"]), f"{prefix}.running_var": _t(s["var"])}


def module_state_dict(kind, params, stats):
    """A JAX module's variables → the port module's state dict (``kind``:
    'stem', 'block' or 'head')."""
    if kind == "head":
        return state_dict_from_jax(params, stats)
    sd = {}
    pre = "net." if kind == "stem" else ""
    for k, v in params.items():
        name = {"downsample_conv": "downsample.0", "downsample_bn": "downsample.1"}.get(k, k)
        if "kernel" in v:
            sd[f"{pre}{name}.weight"] = _conv(v["kernel"])
        else:
            sd.update(_bn(f"{pre}{name}", v, stats[k]))
    return sd


def _away_from_init(rng, params, stats):
    """BatchNorm scales, biases and running statistics moved off their
    init (1, 0, 0, 1), so both modes see a general affine."""
    draw = {"scale": lambda a: rng.uniform(0.5, 1.5, a.shape),
            "bias": lambda a: rng.normal(0, 0.2, a.shape),
            "mean": lambda a: rng.normal(0, 0.2, a.shape),
            "var": lambda a: rng.uniform(0.3, 1.5, a.shape)}

    def move(path, a):
        key = path[-1].key
        return jnp.asarray(draw[key](a), jnp.float32) if key in draw else a

    return (jax.tree_util.tree_map_with_path(move, params),
            jax.tree_util.tree_map_with_path(move, stats))


def _seeded_variables(rng, jmod, args, kw):
    """``jmod``'s variables drawn from ``rng`` without running Flax's
    initializers (a compiled program each): kernels LeCun-normal, the
    rest zero (``_away_from_init`` then draws the BatchNorms')."""
    shapes = jax.eval_shape(lambda *a: jmod.init(jax.random.key(0), *a, train=False, **kw),
                            *args)

    def draw(path, s):
        if path[-1].key == "kernel":
            a = rng.normal(0, np.prod(s.shape[:-1]) ** -0.5, s.shape)
        else:
            a = np.zeros(s.shape)
        return jnp.asarray(a.astype(np.float32), s.dtype)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def jax_module(jmod, args, train, seed, method=None):
    """``jmod`` on ``args`` (parameters drawn from ``seed``, BatchNorms off
    their init), jitted: the forward's output, new statistics, the VJP of
    a seeded bf16 (or f32) cotangent, and the forward's captured
    intermediates."""
    rng = np.random.default_rng(seed)
    kw = {"method": method} if method else {}
    v = _seeded_variables(rng, jmod, args, kw)
    params, stats = _away_from_init(rng, v["params"], v["batch_stats"])
    shapes = jax.eval_shape(lambda p, *a: jmod.apply(
        {"params": p, "batch_stats": stats}, *a, train=train, mutable=["batch_stats"],
        **kw)[0], params, *args)
    ct = jax.tree.map(lambda s: jnp.asarray(rng.normal(0, 1, s.shape), s.dtype), shapes)

    @declared_jit
    @jax.jit
    def run(p, a, ct):
        def f(p, *a):
            out, st = jmod.apply({"params": p, "batch_stats": stats}, *a, train=train,
                                 mutable=["batch_stats", "intermediates"],
                                 capture_intermediates=True, **kw)
            return out, (st["batch_stats"], st["intermediates"])

        out, vjp, (new, inter) = jax.vjp(f, p, *a, has_aux=True)
        return out, new, vjp(ct), inter

    out, new, grads, inter = run(params, tuple(args), ct)
    return {"params": params, "stats": stats, "out": out, "new_stats": new,
            "grads": grads, "ct": ct, "inter": inter}


def readings(pin, port_grads, j_grads, port_stats=None, j_stats=None):
    """The module's readings: per pinned layer (``Pinned.layers``), the
    input cotangents (bf16 steps), the f32 parameter gradients relative
    to each tensor's largest |g| (at least ``sp.GRAD_FLOOR``), the
    running statistics (absolute)."""
    out = {"layers": pin.layers()}
    out["input_cotangents"] = [pn.reading(g, r) for g, r in port_grads["inputs"]]
    worst, at = 0.0, None
    for name, g in port_grads["params"].items():
        ref = j_grads[name]
        rel = float((g - ref).abs().max()) / max(float(ref.abs().max()), sp.GRAD_FLOOR)
        if rel > worst:
            worst, at = rel, name
    out["grad_rel"], out["grad_worst"] = worst, at
    if port_stats is not None:
        out["stats"] = max(float((port_stats[k] - j_stats[k]).abs().max()) for k in j_stats)
    return out


def summary(r):
    """The largest readings of a module: share off and steps over its
    layers, the same over its input cotangents, gradients, statistics."""
    layers = r["layers"].values()
    out = {"layer_off": max(v["off"] for v in layers),
           "layer_steps": max(v["steps"] for v in layers),
           "cot_off": max(v["off"] for v in r["input_cotangents"]),
           "cot_steps": max(v["steps"] for v in r["input_cotangents"]),
           "grad_rel": r["grad_rel"]}
    if "stats" in r:
        out["stats"] = r["stats"]
    return out


def _stem_decisions(inter):
    stem = nchw(inter["bn1"]["__call__"][0])
    convs = [("conv1", nchw(inter["conv1"]["__call__"][0]))]
    return pn.Decisions([("stem", stem)], F.relu(stem), convs)


def _block_decisions(inter, x):
    relus, convs, _ = block_decisions(inter, nchw(x), 1, 0)
    return pn.Decisions(relus, None, convs)


def _head_decisions(inter):
    relus, i = [], 0
    while f"latent_{i}_bn" in inter:
        relus.append((f"latent.{i}", to_torch(inter[f"latent_{i}_bn"]["__call__"][0])))
        i += 1
    return pn.Decisions(relus)


def compare(kind, jmod, pmod, args, train, seed, plant=None):
    """One module of each package on the same input, parameters and
    cotangent; the port's run pinned to the JAX decisions with teacher
    forcing (``plant``: a context made from the port's module, which its run
    is made under) →
    (readings, the JAX output)."""
    import contextlib

    method = JPeraNet.head if kind == "head" else None
    j = jax_module(jmod, args, train, seed, method)
    sd = module_state_dict(kind, j["params"], j["stats"])
    pmod.load_state_dict(sd, strict=kind != "head")
    pmod.train(train)
    if kind == "stem":
        d = _stem_decisions(j["inter"])
        x = (to_torch(args[0]),)
    elif kind == "block":
        d = _block_decisions(j["inter"], args[0])
        x = (nchw(args[0]),)
    else:
        d = _head_decisions(j["inter"])
        feats, pooled = args
        x = ({k: nchw(v) for k, v in feats.items()}, to_torch(pooled))
    for t in (list(x[0].values()) + [x[1]]) if kind == "head" else x:
        t.requires_grad_(True)
    pin = pn.Pinned(d, teacher=True)
    with plant(pmod) if plant else contextlib.nullcontext(), pin:
        if kind == "head":
            out = pmod.head(*x)
            outs = [out["classifier"], out["latent_space"]]
            cts = [to_torch(j["ct"]["classifier"]), to_torch(j["ct"]["latent_space"])]
        else:
            outs, cts = [pmod(*x)], [nchw(j["ct"])]
    torch.autograd.backward(outs, cts)
    g_params, g_x = j["grads"][0], j["grads"][1:]
    if kind == "head":
        jfeats, jpooled = g_x
        inputs = [(x[0][k].grad, nchw(jfeats[k])) for k in sorted(x[0])] + \
                 [(x[1].grad, to_torch(jpooled))]
    elif kind == "stem":
        # the image's cotangent, in bf16 steps: the port rounds it as the
        # cotangent of the image's bf16 cast, XLA leaves it in f32
        inputs = [(x[0].grad.to(torch.bfloat16), to_torch(g_x[0]).to(torch.bfloat16))]
    else:
        inputs = [(x[0].grad, nchw(g_x[0]))]
    grads = module_state_dict(kind, g_params, jax.tree.map(jnp.zeros_like, j["stats"]))
    port_params = {n: p.grad for n, p in pmod.named_parameters() if p.grad is not None}
    j_grads = {n: grads[n] for n in port_params}
    port_stats = j_stats = None
    if train:
        new = module_state_dict(kind, j["params"], j["new_stats"])
        j_stats = {k: v for k, v in new.items() if "running" in k}
        port_stats = {k: v for k, v in pmod.state_dict().items() if k in j_stats}
    return readings(pin, {"inputs": inputs, "params": port_params}, j_grads,
                    port_stats, j_stats), j["out"]


# --- the module limits (tests/test_torch_bf16_layers*.py; readings in the
# docstring of tests/test_torch_bf16_layers.py) ---------------------------------

LIMITS = {"layer_off": 5e-4, "layer_steps": 16.0, "cot_off": 0.1, "cot_steps": 128.0,
          "grad_rel": 1e-2, "stats": 3e-6}
HEAD_LIMITS = {"layer_steps": 25000.0, "cot_steps": 25000.0, "grad_rel": 3e-2, "stats": 2e-6}
TRAIN_CASES = ["stem", "basic", "basic_proj", "bottleneck_proj_w1", "bottleneck_w1",
               "bottleneck_proj_w2", "bottleneck_w2", "head"]
EVAL_CASES = TRAIN_CASES[:1] + ["stem_folded"] + TRAIN_CASES[1:]


def beyond(reading, limits):
    return [k for k, tol in limits.items() if k in reading and not reading[k] <= tol]


def module_readings_within_limits(readings, case):
    r = readings[case]
    return not beyond(r, HEAD_LIMITS if case == "head" else LIMITS), r


# --- the cases -----------------------------------------------------------------

def image(seed, size=32):
    return jnp.asarray(np.random.default_rng(100 + seed).normal(0, 1, (BATCH, size, size, 3)),
                       jnp.float32)


def block_cases(pool_out, seed, train):
    """(name, JAX block, port block, input) of every block case, each on
    its JAX predecessor's output: a basic block without and with a
    projection, and bottleneck blocks with and without one at width
    factors 1 and 2 (filters 32 here; 64 channels in)."""
    b16 = torch.bfloat16
    yield "basic", jr.BasicBlock(64, 1, dtype=BF), pr.BasicBlock(64, 64, 1, b16), pool_out
    yield "basic_proj", jr.BasicBlock(128, 2, dtype=BF), pr.BasicBlock(64, 128, 2, b16), None
    for wf in (1, 2):
        w = 32 * wf
        yield (f"bottleneck_proj_w{wf}", jr.BottleneckBlock(32, w, 2, dtype=BF),
               pr.BottleneckBlock(64, 32, 2, b16, w), pool_out)
        yield (f"bottleneck_w{wf}", jr.BottleneckBlock(32, w, 1, dtype=BF),
               pr.BottleneckBlock(128, 32, 1, b16, w), None)


def head_args(seed):
    rng = np.random.default_rng(200 + seed)

    def relu_bf16(shape):
        return jnp.asarray(np.maximum(rng.normal(0, 1, shape), 0), BF)

    feats = {"layer2": relu_bf16((BATCH, 4, 4, 128)), "layer3": relu_bf16((BATCH, 2, 2, 256))}
    pooled = jnp.asarray(np.asarray(relu_bf16((BATCH, 512)), np.float32).mean(-1, keepdims=True)
                         * rng.uniform(0.5, 1.5, (BATCH, 512)), jnp.float32)
    return feats, pooled


def all_readings(seed, train):
    """{case: summary} of every module case at ``seed`` in one mode."""
    out = {}
    r, pool_out = compare("stem", JStem(), PortStem(), (image(seed),), train, seed)
    out["stem"] = summary(r)
    if not train:
        r, _ = compare("stem", JStem(fold=True), PortStem(fold=True), (image(seed),), train, seed)
        out["stem_folded"] = summary(r)
    prev = pool_out
    for name, jm, pm, x in block_cases(pool_out, seed, train):
        r, prev = compare("block", jm, pm, (prev if x is None else x,), train, seed)
        out[name] = summary(r)
    r, _ = compare("head", JPeraNet(compute_dtype=BF), PeraNet(compute_dtype=torch.bfloat16),
                   head_args(seed), train, seed)
    out["head"] = summary(r)
    return out


def pinned_step(side, batch, plant=None):
    """The JAX fine-tune step (fill on) and the port's under the JAX
    decisions with teacher forcing, bf16 → (margins, per-layer readings);
    ``plant``: as in ``_torch_train.port_step``."""
    import contextlib

    import _torch_train as T

    j = side.step("fine_tune", side.init_state("fine_tune"), batch)
    pin = pn.Pinned(side.decisions(side.params, side.stats, batch), teacher=True)
    tr, metrics, state = T.port_step("fine_tune", side.params, side.stats, batch, pin=pin,
                                     plant=plant, compute_dtype="bfloat16")
    margins = T.step_margins(tr, metrics, state, *j, "fine_tune", pin)
    return margins, pin.layers()


def _print_step():
    import json

    import _torch_train as T

    side = T.make_jax_side(compute_dtype="bfloat16")
    for seed in (1, 2, 3):
        margins, layers = pinned_step(side, T.seeded_batch(seed))
        print(json.dumps({"seed": seed, **margins, **pn.layer_deltas(layers)}), flush=True)


def unpinned_logits(seeds, declared=True):
    """The fine-tune step's train-mode logits in both packages and both
    dtypes from one init (the JAX seed-0 init) on each seed's batch, no
    pinning → {pair: [max |Δlogit| per seed]}, and the logits' scale;
    ``declared``: the bf16 JAX step at declared precision, else at XLA's
    default."""
    import _torch_train as T

    sides = {"float32": T.make_jax_side()}
    sides["bfloat16"] = T.make_jax_side(init=sides["float32"], declared=declared,
                                        compute_dtype="bfloat16")
    pairs = {"port_bf16_vs_jax_bf16": [], "jax_bf16_vs_jax_f32": [],
             "port_bf16_vs_port_f32": [], "port_f32_vs_jax_f32": []}
    scale = 0.0
    for seed in seeds:
        batch = T.seeded_batch(seed)
        lg = {}
        for dtype, side in sides.items():
            _, _, lg[("jax", dtype)], _ = side.step("fine_tune", side.init_state("fine_tune"), batch)
            _, m, _ = T.port_step("fine_tune", side.params, side.stats, batch,
                                  compute_dtype=dtype)
            lg[("port", dtype)] = m["logits"].numpy()
        scale = max(scale, float(np.abs(lg[("jax", "float32")]).max()))
        for pair in pairs:
            a, b = pair.split("_vs_")
            key = {"port_bf16": ("port", "bfloat16"), "jax_bf16": ("jax", "bfloat16"),
                   "port_f32": ("port", "float32"), "jax_f32": ("jax", "float32")}
            pairs[pair].append(T.max_abs(lg[key[a]], lg[key[b]]))
    return pairs, scale


def _print_spread(precision="declared"):
    import json

    pairs, scale = unpinned_logits(range(1, 13), declared=precision == "declared")
    for pair, v in pairs.items():
        print(json.dumps({"pair": pair, "median": float(np.median(v)), "min": min(v),
                          "max": max(v), "per_seed": v}), flush=True)
    print(json.dumps({"logit_scale": scale}), flush=True)


def _print_forward_spread(size="256"):
    import json

    from _torch_train import tpu_one_pass

    from ssad_tpu.config import ModelConfig as JModelConfig
    from ssad_tpu.models.peranet import build_model as jbuild_model
    from ssad_tpu.models.peranet import init_model
    from ssad_tpu_torch.config import ModelConfig
    from ssad_tpu_torch.models.peranet import build_model
    from ssad_tpu_torch.utils.jax_bridge import state_dict_from_jax

    size, pairs = int(size), {}
    for seed in range(4):
        jm = {dt: jbuild_model(JModelConfig(compute_dtype=dt)) for dt in ("float32", "bfloat16")}
        params, stats = jax.jit(lambda k: init_model(jm["float32"], k, (1, 64, 64, 3)))(
            jax.random.key(seed))
        sd = state_dict_from_jax(*jax.tree.map(np.asarray, (params, stats)))
        x = np.random.default_rng(seed).normal(size=(8, size, size, 3)).astype(np.float32)
        lg = {}
        for dt, m in jm.items():
            f = jax.jit(lambda p, s, x, m=m: m.apply({"params": p, "batch_stats": s}, x,
                                                     train=True, mutable=["batch_stats"])[0][
                "classifier"])
            lg[("jax", dt)] = np.asarray(declared_jit(f)(params, stats, x))
            if dt == "bfloat16":
                lg[("jax_tpu", dt)] = np.asarray(declared_jit(tpu_one_pass(f))(params, stats, x))
            model = build_model(ModelConfig(compute_dtype=dt))
            model.load_state_dict(sd, strict=True)
            model.train()
            with torch.no_grad():
                lg[("port", dt)] = model(torch.from_numpy(x))["classifier"].numpy()
        for a, b in ((("jax", "bfloat16"), ("jax", "float32")),
                     (("port", "bfloat16"), ("port", "float32")),
                     (("port", "bfloat16"), ("jax", "bfloat16")),
                     (("port", "float32"), ("jax", "float32")),
                     (("jax_tpu", "bfloat16"), ("jax", "bfloat16"))):
            pairs.setdefault(f"{'_'.join(a)}_vs_{'_'.join(b)}", []).append(
                float(np.abs(lg[a] - lg[b]).max()))
    for pair, v in pairs.items():
        print(json.dumps({"size": size, "pair": pair, "mean": float(np.mean(v)),
                          "per_seed": v}), flush=True)


def _save_grads(out, decisions_dir):
    """The port's pinned bf16 step on seeds 1–3 (``pinned_step``'s port
    half) → its gradients in ``out`` (.npz).  The JAX decisions are kept
    in ``decisions_dir`` by the first run and read by later ones, so runs
    under other CPU settings differ only in the port's own arithmetic."""
    import os

    import _torch_train as T

    side = T.make_jax_side(compute_dtype="bfloat16")
    grads = {}
    for seed in (1, 2, 3):
        batch = T.seeded_batch(seed)
        path = os.path.join(decisions_dir, f"decisions_{seed}.pt")
        if not os.path.exists(path):
            d = side.decisions(side.params, side.stats, batch)
            torch.save({"relus": d.relus, "pool_in": d.pool_in, "convs": d.convs}, path)
        saved = torch.load(path)
        pin = pn.Pinned(pn.Decisions(saved["relus"], saved["pool_in"], saved["convs"]),
                        teacher=True)
        tr, _, _ = T.port_step("fine_tune", side.params, side.stats, batch, pin=pin,
                               compute_dtype="bfloat16")
        grads.update({f"{seed}/{n}": p.grad.numpy() for n, p in tr.model.named_parameters()})
    np.savez(out, **grads)


def _compare_grads(a, b):
    """The largest gradient difference of two ``_save_grads`` files,
    relative to each tensor's largest |g| (at least ``sp.GRAD_FLOOR``)."""
    a, b = np.load(a), np.load(b)
    worst = max((float(np.abs(a[k] - b[k]).max()) / max(float(np.abs(b[k]).max()),
                                                         sp.GRAD_FLOOR), k) for k in b.files)
    print({"grad_rel": worst[0], "at": worst[1]})


def _print_layers():
    import json

    for train in (True, False):
        for seed in (0, 1, 2):
            for case, r in all_readings(seed, train).items():
                print(json.dumps({"mode": "train" if train else "eval", "seed": seed,
                                  "case": case, **r}), flush=True)


if __name__ == "__main__":
    sys.path.insert(0, str(__import__("pathlib").Path(__file__).resolve().parent))
    jax.config.update("jax_platforms", "cpu")
    {"layers": _print_layers, "step": _print_step, "spread": _print_spread,
     "forward-spread": _print_forward_spread,
     "grads": _save_grads, "compare": _compare_grads}[sys.argv[1]](*sys.argv[2:])
