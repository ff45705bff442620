"""The layer-pinned comparison of two forwards (and their backwards):
the parity harness's instrumentation, used by the CPU tests against the
JAX package, the card-vs-CPU test and chip_smoke.py's phase 6; nothing
on a train, evaluate or serve path imports it.

A train-mode forward is piecewise smooth: a ReLU input within rounding
of zero, or a max-pool window with a near tie, takes the other side
under one ulp of noise and moves whole terms of the gradient, and in
bf16 one ulp is 2⁻⁸ of the value.  So two forwards are compared under
one side's decisions (``Recorder`` takes them from a reference run,
``Pinned`` imposes them on another), and with ``teacher`` every ReLU's
output takes the reference's value: each layer then starts from the
reference's input and what differs is that layer's own rounding.  With
the reference's cotangents given as well, each layer's backward starts
from the reference's cotangent too.  ``f32_residual_add`` is a planted
fault the bf16 limits must catch.
"""

from __future__ import annotations

import contextlib
import types
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from ssad_tpu_torch.models.resnet import BasicBlock, BottleneckBlock


class Decisions:
    """A forward's ReLU inputs as (name, tensor) in call order, the stem
    max-pool's input (None: the forward had none), optionally its
    convolutions' outputs as (name, tensor) in call order, and the
    cotangents that reached those outputs in the backward, by name (None:
    not taken)."""

    def __init__(self, relus, pool_in=None, convs=(), cotangents=None):
        self.relus, self.pool_in, self.convs = list(relus), pool_in, list(convs)
        self.cotangents = cotangents

    def to(self, device) -> "Decisions":
        """The activations and cotangents on ``device``; the pool input
        stays where it is, so the windows' argmax is taken there."""
        cots = None if self.cotangents is None else {
            n: c.to(device) for n, c in self.cotangents.items()}
        return Decisions([(n, t.to(device)) for n, t in self.relus], self.pool_in,
                         [(n, t.to(device)) for n, t in self.convs], cots)


def relu_names(model, stem: bool = True) -> List[str]:
    """The names of a PeraNet's ``F.relu`` calls in forward order: the
    stem's (unless the forward starts after it), per block bn1 (and bn2 in
    a bottleneck) and the residual sum, then the latent MLP's."""
    names = ["stem"] if stem else []
    for stage in range(1, 5):
        for b, blk in enumerate(getattr(model.feature_extractor, f"layer{stage}")):
            inner = ("bn1", "bn2") if isinstance(blk, BottleneckBlock) else ("bn1",)
            names += [f"layer{stage}.{b}.{bn}" for bn in inner] + [f"layer{stage}.{b}.sum"]
    latent = sum(isinstance(m, torch.nn.Sequential) for m in model.latent_space)
    return names + [f"latent.{i}" for i in range(latent)]


def conv_names(model, stem: bool = True) -> List[str]:
    """The names of a PeraNet's ``F.conv2d`` calls in forward order: the
    stem's, then per block the projection (a block computes its shortcut
    first), conv1, conv2 (and conv3 in a bottleneck)."""
    names = ["conv1"] if stem else []
    for stage in range(1, 5):
        for b, blk in enumerate(getattr(model.feature_extractor, f"layer{stage}")):
            pre = f"layer{stage}.{b}"
            names += [f"{pre}.downsample"] if blk.downsample is not None else []
            convs = 3 if isinstance(blk, BottleneckBlock) else 2
            names += [f"{pre}.conv{c}" for c in range(1, convs + 1)]
    return names


class Recorder(TorchFunctionMode):
    """Records the decisions of the forward run under it: the inputs of its
    first ``len(names)`` ``F.relu`` calls, the outputs of its first
    ``len(convs)`` ``F.conv2d`` calls, the first ``F.max_pool2d``'s input,
    and with ``cotangents`` the gradient reaching each of those outputs
    that is part of the graph.  Changes nothing."""

    def __init__(self, names: Sequence[str], convs: Sequence[str] = (),
                 cotangents: bool = False):
        super().__init__()
        self.names, self.conv_names = list(names), list(convs)
        self.relus: List[Tuple[str, torch.Tensor]] = []
        self.convs: List[Tuple[str, torch.Tensor]] = []
        self.pool_in = None
        self.cotangents = {} if cotangents else None

    def _keep(self, name: str, out: torch.Tensor) -> None:
        if self.cotangents is not None and out.requires_grad:
            out.register_hook(lambda g: self.cotangents.__setitem__(name, g.detach().clone()))

    def __torch_function__(self, func, types_, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is F.relu and len(self.relus) < len(self.names):
            name = self.names[len(self.relus)]
            self.relus.append((name, args[0].detach().clone()))
            self._keep(name, out)
        elif func is F.conv2d and len(self.convs) < len(self.conv_names):
            name = self.conv_names[len(self.convs)]
            self.convs.append((name, out.detach().clone()))
            self._keep(name, out)
        elif func is F.max_pool2d and self.pool_in is None:
            self.pool_in = args[0].detach().clone()
        return out

    def decisions(self) -> Decisions:
        return Decisions(self.relus, self.pool_in, self.convs, self.cotangents)


class _Teacher(torch.autograd.Function):
    """The reference's value forward, the identity backward."""

    @staticmethod
    def forward(ctx, x, ref):
        return ref.to(x.dtype).clone()

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Given(torch.autograd.Function):
    """The identity forward; backward keeps the incoming cotangent in
    ``sink[name]`` and passes ``given`` on in its place."""

    @staticmethod
    def forward(ctx, y, given, sink, name):
        ctx.given, ctx.sink, ctx.name = given, sink, name
        return y.clone()

    @staticmethod
    def backward(ctx, g):
        ctx.sink[ctx.name] = g.detach().clone()
        return ctx.given.to(g.dtype), None, None, None


class _PoolAt(torch.autograd.Function):
    """The 3×3/s2 max-pool's value at given indices; the backward is the
    max-pool's own (it sums overlapping windows' cotangents in the input's
    dtype, as the unpinned pool and XLA's do in bf16)."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(x, idx)
        return x.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)

    @staticmethod
    def backward(ctx, g):
        x, idx = ctx.saved_tensors
        return torch.ops.aten.max_pool2d_with_indices_backward(
            g, x, [3, 3], [2, 2], [1, 1], [1, 1], False, idx), None


def _round_mantissa(x, bits=10):
    """``x`` rounded to ``bits`` mantissa bits (nearest, ties away), with
    the gradient of the identity: TF32's rounding of a conv input."""
    drop = 23 - bits
    i = x.detach().contiguous().view(torch.int32)
    r = ((i + (1 << (drop - 1))) & ~((1 << drop) - 1)).view(torch.float32)
    return x + (r - x.detach())


def _ulp(scale, dtype=torch.float32):
    return 2.0 ** (np.floor(np.log2(scale)) - (7 if dtype == torch.bfloat16 else 23))


def steps(got: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """|got − ref| in steps of ``ref``'s dtype (one ulp: 2^(e − 7) in bf16,
    2^(e − 23) in f32, at the binade 2^e of |ref|), each taken at
    max(|ref|, 2⁻⁸·max|ref|): elements far below the tensor's scale are
    counted in steps of that floor."""
    r = ref.detach().float().abs()
    mant = 7 if ref.dtype == torch.bfloat16 else 23
    floor = torch.clamp(r.max() * 2.0 ** -8, min=torch.finfo(torch.float32).tiny)
    exponent = torch.frexp(torch.maximum(r, floor)).exponent - 1
    step = torch.ldexp(torch.ones_like(r), exponent - mant)
    return (got.detach().float() - ref.detach().float().to(got.device)).abs() / step


def reading(got: torch.Tensor, ref: torch.Tensor) -> Dict[str, float]:
    """{off: the share of elements not equal, steps: the largest gap in
    ``steps``}."""
    s = steps(got, ref)
    return {"off": float((s > 0).float().mean()), "steps": float(s.max())}


class Pinned(TorchFunctionMode):
    """The forward under ``decisions``: the i-th ``F.relu`` passes exactly
    the units whose reference input is > 0, and the stem's
    ``F.max_pool2d`` takes each window's value at the reference input's
    argmax, so the backward routes every gradient term as the reference's
    did.  ``teacher``: each such ReLU, and each of the decisions'
    convolutions whose reference has the output's dtype, outputs the
    reference's value (the gradient flows back through the forward's own
    op), so every layer starts from the reference's input.  With the
    decisions' cotangents, each of those outputs passes the reference's
    cotangent back in place of its own.
    Each pinned call records the forward's own value (and cotangent).
    Calls past the forward's (the bank fill's eval forward) run as they
    are.  ``round_conv_inputs``: a planted fault that rounds every
    ``F.conv2d`` input to 10 mantissa bits."""

    def __init__(self, decisions: Decisions, round_conv_inputs: bool = False,
                 teacher: bool = False):
        super().__init__()
        self.d, self.round, self.teacher = decisions, round_conv_inputs, teacher
        self.relus, self.convs, self.pool = [], [], None
        self.given = getattr(decisions, "cotangents", None) or {}
        self.cotangents: Dict[str, torch.Tensor] = {}

    def _pass(self, name: str, out: torch.Tensor) -> torch.Tensor:
        if name in self.given and out.requires_grad:
            out = _Given.apply(out, self.given[name], self.cotangents, name)
        return out

    def __torch_function__(self, func, types_, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is F.relu and len(self.relus) < len(self.d.relus):
            x = args[0]
            name, ref = self.d.relus[len(self.relus)]
            self.relus.append(x.detach().clone())
            if self.teacher:
                x = _Teacher.apply(x, ref)
            return self._pass(name, torch.where(ref > 0, x, torch.zeros_like(x)))
        if func is F.max_pool2d and self.pool is None:
            x = args[0]
            _, idx = F.max_pool2d(self.d.pool_in, 3, 2, 1, return_indices=True)
            idx = idx.to(x.device)
            self.pool = (x.detach().clone(), idx)
            if x.dtype == torch.float32:
                return x.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)
            return _PoolAt.apply(x, idx)
        if func is F.conv2d and self.round:
            args = (_round_mantissa(args[0]),) + tuple(args[1:])
        convs = getattr(self.d, "convs", ())
        if func is F.conv2d and len(self.convs) < len(convs):
            name, ref = convs[len(self.convs)]
            out = func(*args, **kwargs)
            self.convs.append(out.detach().clone())
            if self.teacher and ref.dtype == out.dtype:
                out = _Teacher.apply(out, ref)
            return self._pass(name, out)
        return func(*args, **kwargs)

    def report(self) -> Dict:
        """{flips: disagreeing units, band: the farthest one from the
        boundary in units of its layer's spread, worst_layer, spread_ulps:
        the largest layer spread in ulps (of the layer's dtype) of that
        layer's scale (the largest |pre-activation|)}."""
        assert len(self.relus) == len(self.d.relus) and self.pool is not None
        flips, band, worst, spread_ulps = 0, 0.0, None, 0.0
        for (name, ref), got in zip(self.d.relus, self.relus):
            got, ref32 = got.float(), ref.float()
            off = (got > 0) != (ref32 > 0)
            gap = float((got - ref32).abs()[~off].max())
            spread_ulps = max(spread_ulps, gap / _ulp(float(ref32.abs().max()), ref.dtype))
            if off.any():
                flips += int(off.sum())
                far = float(torch.maximum(got[off].abs(), ref32[off].abs()).max())
                if far / gap > band:
                    band, worst = far / gap, name
        x, idx = self.pool
        pool_in = self.d.pool_in.to(x.device)
        _, own = F.max_pool2d(x, 3, 2, 1, return_indices=True)
        off = own != idx
        if off.any():
            flips += int(off.sum())
            xf = x.float().flatten(2)
            tie = (xf.gather(2, own.flatten(2)) - xf.gather(2, idx.flatten(2))).view(idx.shape)
            ratio = float(tie[off].max()) / float((x.float() - pool_in.float()).abs().max())
            if ratio > band:
                band, worst = ratio, "maxpool"
        return {"flips": flips, "band": band, "worst_layer": worst, "spread_ulps": spread_ulps}

    def layers(self) -> Dict[str, Dict[str, float]]:
        """Per pinned call, the reading (``reading``) of the forward's own
        value against the reference's (ReLU inputs by the ReLU's name,
        convolution outputs by the convolution's), and of its own cotangent
        against the reference's where one was given (``<name>.cotangent``)."""
        out = {}
        pairs = list(zip(self.d.relus, self.relus)) + list(zip(self.d.convs, self.convs))
        for (name, ref), got in pairs:
            out[name] = reading(got.to(ref.dtype), ref)
        for name, got in self.cotangents.items():
            out[f"{name}.cotangent"] = reading(got, self.given[name])
        return out


@contextlib.contextmanager
def f32_residual_add(model: torch.nn.Module):
    """A planted fault in ``model``'s basic blocks (each instance's
    ``forward``; the class and other models are untouched): bn2's output
    left in f32, the residual add done in f32 and rounded once, after
    the ReLU (bf16 rounds the BatchNorm's output, then the sum)."""

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        dtype, self.bn2.out_dtype = self.bn2.out_dtype, torch.float32
        try:
            y = self.bn2(self.conv2(y))
        finally:
            self.bn2.out_dtype = dtype
        return F.relu(y + residual.float()).to(x.dtype)

    blocks = [m for m in model.modules() if isinstance(m, BasicBlock)]
    for blk in blocks:
        blk.forward = types.MethodType(forward, blk)
    try:
        yield
    finally:
        for blk in blocks:
            del blk.forward


def layer_deltas(layers: Dict[str, Dict[str, float]]) -> Dict[str, float]:
    """The largest readings of ``Pinned.layers``, by group: share off and
    steps of the backbone's ReLU inputs (``layer``), its convolutions'
    outputs (``conv``), the f32 head's ReLU inputs
    (``head``), and the cotangents of the backbone's and the head's."""
    cot = lambda n: n.endswith(".cotangent")  # noqa: E731
    groups = {"layer": lambda n: not cot(n) and not n.startswith("latent") and not _is_conv(n),
              "conv": lambda n: not cot(n) and _is_conv(n),
              "head": lambda n: not cot(n) and n.startswith("latent"),
              "cotangent": lambda n: cot(n) and not n.startswith("latent"),
              "head_cotangent": lambda n: cot(n) and n.startswith("latent")}
    out = {}
    for group, keep in groups.items():
        vals = [v for n, v in layers.items() if keep(n)]
        if vals:
            out[f"{group}_off"] = max(v["off"] for v in vals)
            out[f"{group}_steps"] = max(v["steps"] for v in vals)
    return out


def _is_conv(name: str) -> bool:
    last = name.split(".")[-1]
    return last.startswith("conv") or last == "downsample"
