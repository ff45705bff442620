"""The transformer trunk's fused pointwise passes (ops/vit_pointwise.py) on
the CPU, against the block's operations as models/vit.py wrote them before
the passes were fused.

``block_before`` and ``swiglu_before`` below are those operations, held
here apart from the code under test: ``norm1(x).to(dt)``, LayerScale's
``gamma * y`` (a bf16 y promoted to f32), the residual ``x + ...``,
``norm2``, and ``F.silu(a) * b`` over ``w12``'s output chunked in two.
Every comparison is of the raw bits (NaN positions compared apart): on the
CPU the plain versions make the same operations in the same order.

Held:
* ``residual_ln_plain`` in each of its three forms (the LayerNorm alone,
  the residual and the LayerNorm, the residual alone) and
  ``silu_mul_plain`` against those operations, bf16 and f32, at tiny
  widths, with values halfway between bf16 steps, signed zeros and
  non-finite values in the SiLU's input;
* a tiny ``VisionTransformer``'s ``(pooled, taps)`` against the same trunk
  with ``Block.forward`` and ``SwiGLU.forward`` put back to the operations
  above, in both dtypes, each tap block's stream included, and the taps
  kept apart (the stream is written out of place);
* the wrappers refuse what the kernels do not take: widths that are not a
  multiple of 8 (and rows wider than 1,536), misaligned and
  non-contiguous views, tensors on several devices, other dtypes, inputs
  autograd would record, a device that is neither CPU nor CUDA; CPU tensors
  never reach the kernels (the launch counts stay).
The kernels themselves are held against the plain versions on the card by
tests/test_torch_vit_pointwise_cuda.py.
"""

import contextlib

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from ssad_tpu_torch.models import vit
from ssad_tpu_torch.ops import vit_pointwise as vp

BITS = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
DTYPES = [torch.bfloat16, torch.float32]


def same(a, b):
    """Equal bits (so the sign of a zero counts), dtypes and shapes; NaN
    where the other has NaN."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    nan = torch.isnan(a)
    return (torch.equal(nan, torch.isnan(b))
            and torch.equal(a.contiguous().view(BITS[a.dtype]).masked_fill(nan, 0),
                            b.contiguous().view(BITS[b.dtype]).masked_fill(nan, 0)))


def stream(shape, gen):
    """An f32 residual stream: rows with their own offsets and scales, and
    values halfway between bf16 steps."""
    x = torch.randn(shape, generator=gen) * (0.5 + 3 * torch.rand(shape[:-1] + (1,),
                                                                    generator=gen))
    x = x + 2 * torch.randn(shape[:-1] + (1,), generator=gen)
    flat = x.view(-1)
    flat[::7] = torch.round(flat[::7] * 256) / 256 + 2.0 ** -9
    return x


def layer_norm(c, gen):
    norm = nn.LayerNorm(c, eps=vit.LN_EPS)
    with torch.no_grad():
        norm.weight.copy_(0.8 + 0.4 * torch.rand(c, generator=gen))
        norm.bias.copy_(0.1 * torch.randn(c, generator=gen))
    return norm.requires_grad_(False)


def branch(shape, dtype, gen):
    y = torch.randn(shape, generator=gen).to(dtype)
    y.view(-1)[1] = -0.0
    return y


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", [(2, 5, 8), (3, 7, 32), (1, 4, 40)])
def test_residual_ln_plain_is_the_blocks_operations(shape, dtype):
    gen = torch.Generator().manual_seed(sum(shape))
    c = shape[-1]
    x, y = stream(shape, gen), branch(shape, dtype, gen)
    gamma = 1.0 + 0.2 * torch.randn(c, generator=gen)
    norm = layer_norm(c, gen)
    ln = (norm.weight, norm.bias, norm.eps)

    # the LayerNorm alone: norm1(x).to(dt)
    out, n = vp.residual_ln_plain(x, ln=ln, dtype=dtype)
    assert out is x and same(n, norm(x).to(dtype))
    # the residual and the LayerNorm: x + ls1(y), then norm2(x).to(dt)
    expected = x + gamma * y
    out, n = vp.residual_ln_plain(x, y, gamma, ln, dtype)
    assert same(out, expected) and same(n, norm(expected).to(dtype))
    assert out.dtype == torch.float32 and out.data_ptr() != x.data_ptr()
    # the residual alone: x + ls2(y)
    out, n = vp.residual_ln_plain(x, y, gamma)
    assert same(out, expected) and n is None
    # the dispatcher takes the plain version for CPU tensors
    before = vp.residual_ln_cuda.launches
    out, n = vp.residual_ln(x, y, gamma, ln, dtype)
    assert same(out, expected) and same(n, norm(expected).to(dtype))
    assert vp.residual_ln_cuda.launches == before


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", [(2, 3, 16), (5, 88 * 2), (1, 2, 4, 64)])
def test_silu_mul_plain_is_the_swiglus_operations(shape, dtype):
    gen = torch.Generator().manual_seed(sum(shape) + 1)
    h = (3 * torch.randn(shape, generator=gen)).to(dtype)
    flat = h.view(-1)
    flat[:6] = torch.tensor([float("nan"), float("inf"), float("-inf"), -100.0, -0.0, 0.0])
    flat[6::5] = (torch.round(flat[6::5].float() * 64) / 64 + 2.0 ** -8).to(dtype)
    a, b = h.chunk(2, dim=-1)
    expected = F.silu(a) * b
    before = vp.silu_mul_cuda.launches
    for out in (vp.silu_mul_plain(h), vp.silu_mul(h)):
        assert same(out, expected)
    assert vp.silu_mul_cuda.launches == before


def block_before(self, x):
    """``Block.forward`` as models/vit.py wrote it before the fused passes."""
    dt = self.compute_dtype
    x = x + self.ls1.gamma * self.attn(self.norm1(x).to(dt))
    return x + self.ls2.gamma * self.mlp(self.norm2(x).to(dt))


def swiglu_before(self, x):
    a, b = vit._linear(x, self.w12).chunk(2, dim=-1)
    return vit._linear(F.silu(a) * b, self.w3)


@contextlib.contextmanager
def operations_before():
    saved = vit.Block.forward, vit.SwiGLU.forward
    vit.Block.forward, vit.SwiGLU.forward = block_before, swiglu_before
    try:
        yield
    finally:
        vit.Block.forward, vit.SwiGLU.forward = saved


def tiny_trunk(dtype, seed=5):
    gen = torch.Generator().manual_seed(seed)
    model = vit.VisionTransformer(embed_dim=32, depth=4, num_heads=4, patch_size=14, img_size=70,
                                  num_register_tokens=4, dtype=dtype)
    with torch.no_grad():
        for name, p in model.named_parameters():
            scale = 0.3 if p.ndim > 1 else 0.2
            p.copy_(scale * torch.randn(p.shape, generator=gen) + (1.0 if name.endswith(
                ("gamma", "norm1.weight", "norm2.weight", "norm.weight")) else 0.0))
    return model.eval()


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_tiny_trunk_is_the_blocks_operations(dtype):
    """(pooled, taps) and each tap block's stream, bit for bit."""
    model = tiny_trunk(dtype)
    x = torch.randn(2, 3, 84, 98, generator=torch.Generator().manual_seed(9))
    streams = {}

    def keep(i):
        return lambda module, args, out: streams.setdefault(i, []).append(out)

    hooks = [b.register_forward_hook(keep(i)) for i, b in enumerate(model.blocks, start=1)]
    try:
        with torch.inference_mode():
            pooled, taps = model(x)
            with operations_before():
                pooled0, taps0 = model(x)
    finally:
        for h in hooks:
            h.remove()
    assert same(pooled, pooled0)
    for name in vit.TAPS:
        assert same(taps[name], taps0[name]), name
    for i in model.tap_blocks:
        fused, before = streams[i]
        assert same(fused, before), i
    # the taps are four distinct tensors: no block wrote over an earlier stream
    assert len({streams[i][0].data_ptr() for i in model.tap_blocks}) == 4
    assert not same(taps["layer1"], taps["layer2"])


def test_refusals():
    c = 32
    x, y, gamma = torch.zeros(3, c), torch.zeros(3, c, dtype=torch.bfloat16), torch.ones(c)
    ln = (torch.ones(c), torch.zeros(c), 1e-6)
    bf16 = torch.bfloat16
    # widths: a multiple of 8, and rows a warp can hold
    for w in (12, 1544):
        with pytest.raises(ValueError, match="multiples of 8"):
            vp.residual_ln_cuda(torch.zeros(2, w), ln=(torch.ones(w), torch.zeros(w), 1e-6),
                                dtype=bf16)
    with pytest.raises(ValueError, match="multiples of 8"):
        vp.silu_mul_cuda(torch.zeros(2, 24, dtype=bf16))
    # misaligned and non-contiguous views
    shifted = torch.zeros(3 * c + 1)[1:].view(3, c)
    assert shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte-aligned"):
        vp.residual_ln_cuda(shifted, ln=ln, dtype=bf16)
    with pytest.raises(ValueError, match="16-byte-aligned"):
        vp.residual_ln_cuda(x, torch.zeros(3, 2 * c, dtype=bf16)[:, :c], gamma)
    with pytest.raises(ValueError, match="16-byte-aligned"):
        vp.silu_mul_cuda(torch.zeros(3 * 64 + 8, dtype=bf16)[8:].view(3, 64)[:, :32])
    with pytest.raises(ValueError, match="16-byte-aligned"):
        vp.silu_mul_cuda(torch.zeros(3 * 64 + 1, dtype=bf16)[1:].view(3, 64))
    # several devices, in the plain version and the kernel's wrapper alike
    for fn in (vp.residual_ln, vp.residual_ln_cuda):
        with pytest.raises(ValueError, match="several devices"):
            fn(x, y, torch.ones(c, device="meta"))
    # dtypes
    with pytest.raises(ValueError, match="must be float32"):
        vp.residual_ln(x.to(bf16), ln=ln, dtype=bf16)
    with pytest.raises(ValueError, match="must share a dtype"):
        vp.residual_ln_cuda(x, y, gamma, ln, torch.float32)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        vp.silu_mul_cuda(torch.zeros(3, 32, dtype=torch.float16))
    with pytest.raises(ValueError, match="output dtype"):
        vp.residual_ln(x, ln=ln, dtype=torch.float16)
    # malformed calls
    with pytest.raises(ValueError, match="needs a branch output"):
        vp.residual_ln(x)
    with pytest.raises(ValueError, match="both y and gamma"):
        vp.residual_ln(x, y)
    with pytest.raises(ValueError, match="do not match"):
        vp.residual_ln(x, y[:2], gamma)
    with pytest.raises(ValueError, match="even last dimension"):
        vp.silu_mul(torch.zeros(3, 33))
    # what autograd would record; and CPU tensors given to the kernel
    with pytest.raises(ValueError, match="no gradient"):
        vp.residual_ln_cuda(x, y, gamma.clone().requires_grad_())
    with torch.no_grad():
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            vp.residual_ln_cuda(x, y, gamma.clone().requires_grad_())
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        vp.silu_mul_cuda(torch.zeros(3, 32, dtype=bf16))
    # a device that is neither
    with pytest.raises(ValueError, match="CUDA device or on the CPU"):
        vp.residual_ln(torch.zeros(3, c, device="meta"), ln=ln, dtype=bf16)
    with pytest.raises(ValueError, match="CUDA device or on the CPU"):
        vp.silu_mul(torch.zeros(3, 32, device="meta"))
