"""The inference BatchNorm kernel (csrc/bn_act.cu) against its plain
PyTorch version, on the card, bit for bit (the raw bits, so the sign of a
zero counts; NaN positions compared apart): the kernel does the chain's
IEEE f32 operations in the chain's order and rounds where it rounds, so
no tolerance is given.  Every test takes the ``cuda_device`` fixture and
skips where there is no card.

Held: every dtype, layout, residual and ReLU case, widths and NCHW planes
that split a vector between channels, and signed zeros; misaligned views,
ragged element counts, other dtypes and strides refused; every site of both
trunks at the served patch batch (6,728 windows, channels last) and of the
image path's batch (64 × 256²); one served patch batch launches the
kernel once per site, and no site of the trunk runs the chain.

This file imports neither JAX nor the JAX package, so it runs on a
machine without them:
    python -m pytest --noconftest tests/test_torch_bn_act_cuda.py
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from _torch_port import cuda_device, seeded_state_dict  # noqa: F401  (fixture)

from ssad_tpu_torch.config import ModelConfig
from ssad_tpu_torch.evaluation.inference import InferenceEngine
from ssad_tpu_torch.models import resnet
from ssad_tpu_torch.models.peranet import build_model
from ssad_tpu_torch.ops import bn_act as ba

SERVED_IMAGES = 8  # 8 × 841 = 6,728 windows of 32² at stride 8
IMAGE_BATCH = 64


BITS = {torch.bfloat16: torch.int16, torch.float32: torch.int32}


def same(a, b):
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    nan = torch.isnan(a)
    return (torch.equal(nan, torch.isnan(b))
            and torch.equal(a.view(BITS[a.dtype]).masked_fill(nan, 0),
                            b.view(BITS[b.dtype]).masked_fill(nan, 0)))


def activation(shape, dtype, layout, gen, device):
    n, c, *spatial = shape
    t = 2 * torch.randn((n, *spatial, c), generator=gen, device=device)
    flat = t.view(-1)
    flat[::7] = torch.round(flat[::7] * 256) / 256 + 2.0 ** -9  # halfway between bf16 steps
    flat[3], flat[5], flat[11] = float("nan"), float("inf"), float("-inf")
    t = t.to(dtype).permute(0, t.ndim - 1, *range(1, t.ndim - 1))
    return t if layout == "channels_last" else t.contiguous()


def affine(c, gen, device):
    var = 0.5 + 1.5 * torch.rand(c, generator=gen, device=device)
    weight = 0.5 + torch.rand(c, generator=gen, device=device)
    return (0.3 * torch.randn(c, generator=gen, device=device),
            torch.rsqrt(var + 1e-5) * weight, 0.2 * torch.randn(c, generator=gen, device=device))


def check(x, aff, relu, r, raff):
    before = ba.bn_act_cuda.launches
    out = ba.bn_act(x, aff, relu, r, raff)
    torch.cuda.synchronize()
    assert ba.bn_act_cuda.launches == before + 1
    assert out.stride() == x.stride()
    assert same(out, ba.bn_act_plain(x, aff, relu, r, raff))
    return out


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("residual", ["none", "identity", "normed"])
@pytest.mark.parametrize("shape", [(3, 16, 40), (2, 24, 5, 6), (2, 12, 7, 7), (5, 64, 16, 16),
                                   (3, 2048, 2, 2), (4, 8, 1, 1)])
@pytest.mark.parametrize("layout", ["contiguous", "channels_last"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_kernel_matches_plain(cuda_device, dtype, layout, shape, residual, relu):  # noqa: F811
    gen = torch.Generator(device=cuda_device).manual_seed(sum(shape) + len(residual) + relu)
    x = activation(shape, dtype, layout, gen, cuda_device)
    r = None if residual == "none" else activation(shape, dtype, layout, gen, cuda_device)
    raff = affine(shape[1], gen, cuda_device) if residual == "normed" else None
    check(x, affine(shape[1], gen, cuda_device), relu, r, raff)


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("residual", ["none", "identity", "normed"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_kernel_keeps_the_chains_sign_of_zero(cuda_device, dtype, residual, relu):  # noqa: F811
    # −0 − 0 = −0, times a positive mul, plus a −0 bias: a −0 wherever x
    # has one, and the residual's the same, so a −0 meets the ReLU
    shape = (4, 16, 6, 6)
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    x = activation(shape, dtype, "channels_last", gen, cuda_device)
    x.permute(0, 2, 3, 1).view(-1)[::3] = -0.0
    zero = torch.zeros(16, device=cuda_device)
    aff = (zero, 0.5 + torch.rand(16, generator=gen, device=cuda_device), -zero)
    r = None if residual == "none" else x.clone()
    raff = aff if residual == "normed" else None
    pre = ba.bn_act_plain(x, aff, False, r, raff).permute(0, 2, 3, 1).reshape(-1)[::3]
    assert bool((pre == 0).all() and torch.signbit(pre).all())
    check(x, aff, relu, r, raff)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_kernel_refuses_misaligned_views(cuda_device, dtype):  # noqa: F811
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    shape = (4, 64, 8, 8)
    base = activation((shape[0] * 2,) + shape[1:], dtype, "contiguous", gen, cuda_device)
    x = base.view(-1)[1:1 + math.prod(shape)].view(shape)  # 2 or 4 bytes off 16
    aligned = base[:shape[0]]
    with pytest.raises(ValueError, match="16-byte-aligned"):
        ba.bn_act_cuda(x, affine(64, gen, cuda_device))
    with pytest.raises(ValueError, match="16-byte-aligned"):
        ba.bn_act_cuda(aligned, affine(64, gen, cuda_device), residual=x)
    with pytest.raises(ValueError, match="16-byte-aligned"):  # 3 × 5 × 5: a ragged last vector
        ba.bn_act_cuda(base[:1, :3, :5, :5].contiguous(), affine(3, gen, cuda_device))


def test_kernel_refuses_other_dtypes_and_strides(cuda_device):  # noqa: F811
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    x = activation((2, 16, 6, 6), torch.bfloat16, "channels_last", gen, cuda_device)
    aff = affine(16, gen, cuda_device)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        ba.bn_act_cuda(x.half(), aff)
    with pytest.raises(ValueError, match="channels-last or NCHW"):
        ba.bn_act_cuda(x[:, :, ::2], aff)
    with pytest.raises(ValueError, match="channels-last or NCHW"):
        ba.bn_act_cuda(x, aff, residual=x.contiguous())  # the residual in another layout
    with pytest.raises(ValueError, match="differs from x"):
        ba.bn_act_cuda(x, aff, residual=x.float())


# --- the trunk's sites at the served shapes ----------------------------------

def served_model(arch, device):
    model = build_model(ModelConfig(backbone=arch, compute_dtype="bfloat16"))
    model.load_state_dict(seeded_state_dict(model, 0), strict=True)
    return InferenceEngine(model, device)


def images(n, seed):
    return torch.from_numpy(np.random.default_rng(seed).normal(0, 1, (n, 256, 256, 3))
                            .astype(np.float32))


class Checked:
    """Each ``bn_act`` call of the trunk held against ``bn_act_plain`` on
    the same inputs when it is made: (x's shape, channels last, residual,
    projection residual, bit-equal) per call."""

    def __init__(self, monkeypatch):
        self.sites = []

        def checked(x, aff, relu=True, residual=None, residual_affine=None):
            out = ba.bn_act(x, aff, relu, residual, residual_affine)
            ref = ba.bn_act_plain(x, aff, relu, residual, residual_affine)
            self.sites.append((tuple(x.shape), x.is_contiguous(memory_format=torch.channels_last),
                               residual is not None, residual_affine is not None, same(out, ref)))
            return out

        monkeypatch.setattr(resnet, "bn_act", checked)


class TrunkRelus:
    """Counts ``F.relu`` calls on 4-D activations (the trunk's chain) from
    here to the test's end.  Not a function mode: under one the trunk
    chains (``resnet.one_pass``)."""

    def __init__(self, monkeypatch):
        self.calls, relu = 0, F.relu

        def counted(x, *args, **kwargs):
            self.calls += x.ndim == 4
            return relu(x, *args, **kwargs)

        monkeypatch.setattr(F, "relu", counted)


def sites(model, stem):
    blocks = [b for s in range(1, 5) for b in getattr(model.feature_extractor, f"layer{s}")]
    return int(stem) + sum(2 if isinstance(b, resnet.BasicBlock) else 3 for b in blocks)


@pytest.mark.parametrize("arch", ["resnet18", "wide_resnet50_2"])
def test_served_patch_batch_every_site_bit_equal(cuda_device, monkeypatch, arch):  # noqa: F811
    engine = served_model(arch, cuda_device)
    checked = Checked(monkeypatch)
    logits, emb, n = engine.predict_patches(images(SERVED_IMAGES, 1))
    assert n * SERVED_IMAGES == 6728 and torch.isfinite(emb).all()
    assert len(checked.sites) == sites(engine.model, stem=False)
    assert all(s[0][0] == 6728 and s[1] for s in checked.sites), checked.sites
    assert all(s[4] for s in checked.sites), [s for s in checked.sites if not s[4]]
    blocks = [m for m in engine.model.modules() if isinstance(m, resnet.BottleneckBlock)
              or isinstance(m, resnet.BasicBlock)]
    assert sum(s[3] for s in checked.sites) == sum(b.downsample is not None for b in blocks)


@pytest.mark.parametrize("arch", ["resnet18", "wide_resnet50_2"])
def test_served_patch_batch_launches_once_per_site(cuda_device, monkeypatch, arch):  # noqa: F811
    engine = served_model(arch, cuda_device)
    x = images(SERVED_IMAGES, 2)
    engine.predict_patches(x)  # built and warm
    before, relus = ba.bn_act_cuda.launches, TrunkRelus(monkeypatch)
    engine.predict_patches(x)
    torch.cuda.synchronize()
    assert ba.bn_act_cuda.launches - before == sites(engine.model, stem=False)
    assert relus.calls == 0


def test_image_batch_every_site_bit_equal_and_launched(cuda_device, monkeypatch):  # noqa: F811
    engine = served_model("resnet18", cuda_device)
    x = images(IMAGE_BATCH, 3)
    before, relus = ba.bn_act_cuda.launches, TrunkRelus(monkeypatch)
    engine.predict_batch(x)
    torch.cuda.synchronize()
    assert ba.bn_act_cuda.launches - before == sites(engine.model, stem=True)
    assert relus.calls == 0
    checked = Checked(monkeypatch)
    engine.predict_batch(x)
    assert checked.sites[0][0] == (IMAGE_BATCH, 64, 128, 128) and checked.sites[0][1]
    assert len(checked.sites) == sites(engine.model, stem=True)
    assert all(s[4] for s in checked.sites), [s for s in checked.sites if not s[4]]
