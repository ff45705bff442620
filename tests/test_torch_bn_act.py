"""The one-pass inference BatchNorm → (+ residual) → ReLU (ops/bn_act.py)
against the eval-mode chain it replaces, on the CPU.

``chain`` below is the eval-mode chain as models/resnet.py computed it
before the one pass: ``FlaxBatchNorm.forward``'s affine in f32, rounded to
the compute dtype, then ``y + residual`` and ``F.relu``; it is the
yardstick, held here apart from the code under test.  Every comparison is
of the raw bits (NaN positions compared apart): the one pass is the same
arithmetic in the same order, so the bits must not move.

Also held: the eval forwards of PeraNet ResNet-18 and Wide-ResNet-50-2 on
32² windows (the folded stem), from the stem's output (``from_stem``, the
served patch path) and on 64² images take the one pass at every site of
the trunk and give the module-by-module forward's bits; train mode and a
forward whose graph autograd records keep the chain, and so does one
under a torch function mode (the pinning harness's); reference-layout
weights still load with ``strict=True``.  The kernel itself is held
against ``bn_act_plain`` on the card by tests/test_torch_bn_act_cuda.py.
"""

import zlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from _torch_port import seeded_state_dict
from test_ref_checkpoint import reference_state_dict

from ssad_tpu_torch.config import ModelConfig
from ssad_tpu_torch.models import resnet
from ssad_tpu_torch.models.peranet import build_model
from ssad_tpu_torch.ops import bn_act as ba
from ssad_tpu_torch.ops import stem_pool
from ssad_tpu_torch.train import _pinning as pn

torch.set_num_threads(1)


def chain(x, bn, relu=True, residual=None, residual_bn=None):
    """The eval-mode chain: ``bn`` and ``residual_bn`` are (mean, var,
    weight, bias, eps)."""
    def norm(t, p):
        mean, var, weight, bias, eps = p
        shape = (1, -1) + (1,) * (t.ndim - 2)
        mul = torch.rsqrt(var + eps) * weight
        y = (t.float() - mean.view(shape)) * mul.view(shape)
        return (y + bias.view(shape)).to(t.dtype)

    if residual is not None and residual_bn is not None:
        residual = norm(residual, residual_bn)
    y = norm(x, bn)
    if residual is not None:
        y = y + residual
    return F.relu(y) if relu else y


def affine(p):
    mean, var, weight, bias, eps = p
    return mean, torch.rsqrt(var + eps) * weight, bias


BITS = {torch.bfloat16: torch.int16, torch.float32: torch.int32}


def same(a, b):
    """Equal bits (so the sign of a zero counts) and dtypes; NaN where the
    other has NaN."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    nan = torch.isnan(a)
    return (torch.equal(nan, torch.isnan(b))
            and torch.equal(a.view(BITS[a.dtype]).masked_fill(nan, 0),
                            b.view(BITS[b.dtype]).masked_fill(nan, 0)))


def bn_params(c, gen):
    return (0.3 * torch.randn(c, generator=gen), 0.5 + 1.5 * torch.rand(c, generator=gen),
            0.5 + torch.rand(c, generator=gen), 0.2 * torch.randn(c, generator=gen), 1e-5)


def activation(shape, dtype, layout, gen, scale=2.0):
    """Seeded values in ``layout``: 'contiguous' (NCHW) or 'channels_last'
    (C innermost), some on bf16 rounding boundaries, one NaN, ±inf."""
    n, c, *spatial = shape
    t = scale * torch.randn((n, *spatial, c), generator=gen)
    flat = t.view(-1)
    flat[::7] = torch.round(flat[::7] * 256) / 256 + 2.0 ** -9  # halfway between bf16 steps
    flat[3], flat[5], flat[11] = float("nan"), float("inf"), float("-inf")
    t = t.to(dtype)
    if layout == "channels_last":
        return t.permute(0, t.ndim - 1, *range(1, t.ndim - 1))
    return t.permute(0, t.ndim - 1, *range(1, t.ndim - 1)).contiguous()


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("residual", ["none", "identity", "normed"])
@pytest.mark.parametrize("shape", [(3, 16, 40), (2, 24, 5, 6)], ids=["1d", "2d"])
@pytest.mark.parametrize("layout", ["contiguous", "channels_last"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_plain_equals_the_chain(dtype, layout, shape, residual, relu):
    case = repr((dtype, layout, shape, residual, relu)).encode()
    gen = torch.Generator().manual_seed(zlib.crc32(case))
    c = shape[1]
    x = activation(shape, dtype, layout, gen)
    bn, rbn = bn_params(c, gen), bn_params(c, gen)
    r = None if residual == "none" else activation(shape, dtype, layout, gen)
    want = chain(x, bn, relu, r, rbn if residual == "normed" else None)
    got = ba.bn_act(x, affine(bn), relu, r, affine(rbn) if residual == "normed" else None)
    assert same(got, want)
    assert torch.isnan(got).any() and torch.isinf(got).any()
    if relu:
        assert bool((got[~torch.isnan(got)] >= 0).all())


def test_plain_refuses_mismatched_arguments():
    gen = torch.Generator().manual_seed(0)
    x = activation((2, 8, 4, 4), torch.bfloat16, "contiguous", gen)
    aff = affine(bn_params(8, gen))
    with pytest.raises(ValueError, match="vectors"):
        ba.bn_act_plain(x, [t[:4] for t in aff])
    with pytest.raises(ValueError, match="needs a residual"):
        ba.bn_act_plain(x, aff, residual_affine=aff)
    with pytest.raises(ValueError, match="does not match"):
        ba.bn_act_plain(x, aff, residual=x[:1])
    with pytest.raises(ValueError, match="bn_act_cuda needs CUDA"):
        ba.bn_act_cuda(x, aff)
    with pytest.raises(ValueError, match="CUDA device or on the CPU"):
        ba.bn_act(x.to("meta"), aff)


def test_layouts_ignore_size_one_dims():
    x = torch.empty((4, 8, 3, 5)).to(memory_format=torch.channels_last)
    assert ba._layouts(x) == {"channels_last"}
    assert ba._layouts(x.contiguous()) == {"contiguous"}
    assert ba._layouts(torch.empty((4, 8, 1, 1))) == {"channels_last", "contiguous"}
    assert ba._layouts(torch.empty((4, 8))) == {"channels_last", "contiguous"}
    assert ba._layouts(torch.empty((4, 8, 6, 6))[:, :, ::2]) == set()
    assert ba._layouts(torch.empty((4, 6, 6, 8)).permute(0, 3, 2, 1)) == set()


# --- the trunk's call sites --------------------------------------------------

def model_for(arch, dtype, seed=0):
    model = build_model(ModelConfig(backbone=arch, compute_dtype=dtype))
    sd = reference_state_dict(seed) if arch == "resnet18" else seeded_state_dict(model, seed)
    model.load_state_dict(sd, strict=True)
    return model.eval()


class Count:
    """Counts ``models.resnet.bn_act`` calls while in use."""

    def __init__(self, monkeypatch):
        self.calls = 0

        def counted(*args, **kwargs):
            self.calls += 1
            return ba.bn_act(*args, **kwargs)

        monkeypatch.setattr(resnet, "bn_act", counted)


def sites(model, stem=True):
    """The one-pass sites of a forward: the stem, and per block its inner
    BatchNorm + ReLU pairs and the last BatchNorm with the shortcut."""
    blocks = [b for s in range(1, 5) for b in getattr(model.feature_extractor, f"layer{s}")]
    per = {resnet.BasicBlock: 2, resnet.BottleneckBlock: 3}
    return int(stem) + sum(per[type(b)] for b in blocks)


def image(size, n, seed):
    return torch.from_numpy(np.random.default_rng(seed).normal(0, 1, (n, size, size, 3))
                            .astype(np.float32))


def run(model, fn, *args):
    """(no-grad forward through the one pass, forward whose graph autograd
    records: the module-by-module chain)."""
    with torch.inference_mode():
        fused = fn(*args)
    chained = fn(*args)
    assert chained["latent_space"].requires_grad
    return fused, chained


@pytest.mark.parametrize("entry", ["windows32", "from_stem", "image64"])
@pytest.mark.parametrize("arch, dtype", [("resnet18", "bfloat16"), ("resnet18", "float32"),
                                         ("wide_resnet50_2", "bfloat16")])
def test_eval_forward_takes_the_one_pass_bit_for_bit(monkeypatch, arch, dtype, entry):
    model = model_for(arch, dtype)
    count = Count(monkeypatch)
    if entry == "windows32":
        fn, arg, stem = model, image(32, 3, 1), True
    elif entry == "from_stem":
        affine_ = stem_pool.folded_stem_affine(model.state_dict())
        x = image(32, 3, 2).to(model.compute_dtype)
        arg = stem_pool.stem_pool_plain(x, *affine_)
        fn, stem = model.from_stem, False
    else:
        fn, arg, stem = model, image(64, 2, 3), True
    fused, chained = run(model, fn, arg)
    assert count.calls == sites(model, stem)
    for key in ("classifier", "latent_space"):
        assert torch.equal(fused[key], chained[key].detach()), key
    assert torch.isfinite(fused["latent_space"]).all()


def test_train_mode_and_recorded_graphs_keep_the_chain(monkeypatch):
    model = model_for("resnet18", "bfloat16", seed=4)
    count = Count(monkeypatch)
    x = image(32, 2, 5)
    model.train()
    with torch.no_grad():
        model(x)  # train mode: batch statistics, whatever the grad mode
    model.eval()
    model(x)  # eval, parameters requiring grad: the graph is recorded
    assert count.calls == 0
    with torch.no_grad():
        model(x)
    assert count.calls == sites(model)
    for p in model.parameters():
        p.requires_grad_(False)
    model(x)  # grad mode on, nothing requires grad: nothing recorded
    assert count.calls == 2 * sites(model)
    model(x.requires_grad_(True))  # the input records a graph
    assert count.calls == 2 * sites(model)


def test_a_function_mode_sees_every_relu_of_the_chain(monkeypatch):
    # train/_pinning's Recorder reads each ReLU's input: under it the trunk
    # chains, with the one pass's bits
    model = model_for("resnet18", "bfloat16", seed=8)
    count = Count(monkeypatch)
    x = image(32, 2, 9)
    with torch.inference_mode():
        want = model(x)
    assert count.calls == sites(model)
    names = pn.relu_names(model)
    rec = pn.Recorder(names, pn.conv_names(model))
    with torch.inference_mode(), rec:
        got = model(x)
    assert count.calls == sites(model)
    assert [n for n, _ in rec.relus] == names and len(rec.convs) == len(pn.conv_names(model))
    for key in ("classifier", "latent_space"):
        assert same(got[key], want[key]), key


def test_a_norm_in_train_mode_or_another_dtype_keeps_the_chain(monkeypatch):
    model = model_for("resnet18", "bfloat16", seed=6)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    count = Count(monkeypatch)
    proj, last = model.feature_extractor.layer2[0], model.feature_extractor.layer4[1]
    x = image(32, 2, 7)
    with torch.inference_mode():
        want = model(x)
        proj.downsample[1].train()  # one BatchNorm in train mode: its block chains
        model(x)
        assert count.calls == 2 * sites(model) - 2
        proj.downsample[1].eval()
        last.bn2.out_dtype = torch.float32  # an f32 output in a bf16 block: the chain
        model(x)
        last.bn2.out_dtype = torch.bfloat16
    model.load_state_dict(state)  # the train-mode forward moved the running statistics
    with torch.inference_mode():
        got = model(x)
    assert count.calls == 4 * sites(model) - 4
    assert torch.equal(got["latent_space"], want["latent_space"])


def test_state_dict_names_are_unchanged():
    """A reference-layout checkpoint loads with strict=True, and the module
    tree holds no more and no fewer keys than the reference's."""
    sd = reference_state_dict(3)
    model = build_model(ModelConfig())
    assert set(model.state_dict()) == set(sd)
    model.load_state_dict(sd, strict=True)
