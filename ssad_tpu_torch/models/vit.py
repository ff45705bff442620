"""DINOv2 vision transformers with registers, as PeraNet trunks.

The trunk of DINOv2 (Oquab et al. 2023, arXiv 2304.07193) with register
tokens (Darcet et al. 2023, arXiv 2309.16588): facebookresearch/dinov2's
``dinov2/models/vision_transformer.py`` ``DinoVisionTransformer`` with
``block_chunks=0``, ``ffn_layer="swiglufused"``, LayerScale
(``init_values=1.0``), ``interpolate_antialias=True`` and
``interpolate_offset=0.0``.  ``BACKBONES`` holds the one published preset
``dinov2_vitg14_reg`` (``hubconf.py``, ``vit_giant2``): width 1536, 40
blocks, 24 heads of 64, SwiGLU hidden width 4096, patch 14, 4 registers,
a 37 × 37 position table (``img_size`` 518).  Parameter names are
DINOv2's, so ``dinov2_vitg14_reg4_pretrain.pth`` loads under
``feature_extractor.`` with ``strict=True`` (``mask_token`` is held for
that and is not used).

The forward takes ImageNet-normalised NCHW images whose sides are
multiples of the patch (any other size is refused) and returns what
``ResNet.forward`` returns, ``(pooled, {'layer1'..'layer4'})``:

1. tokens: ``patch_embed.proj`` (a 14 × 14 / stride 14 convolution with
   bias) → (B, h·w, C); ``cls_token`` first; the position table added, its
   CLS row as it is and its patch rows resampled in f32 to (h, w) by
   antialiased bicubic interpolation (used unchanged when the grid is the
   table's own and square); then the registers after the CLS token, with
   no position;
2. blocks: ``x += ls1.gamma ⊙ proj(attn(norm1(x)))`` and
   ``x += ls2.gamma ⊙ w3(silu(a) ⊙ b)``, ``a, b = w12(norm2(x)).chunk(2)``;
   LayerNorm eps 1e-6; softmax(q kᵀ / √64) v over every token;
3. outputs: ``pooled`` is ``norm(x)[:, 0]`` after the last block; the taps
   ``layer1..layer4`` are ``norm(x)`` of the patch tokens after blocks
   depth/4, depth/2, 3·depth/4 and depth (10, 20, 30, 40), as (B, C, h, w)
   grids: DINOv2's ``get_intermediate_layers(n=[9, 19, 29, 39],
   reshape=True, norm=True)``.  ``stage_channels`` is C for every tap.

Precision with ``compute_dtype=bfloat16`` is the order that
``torch.autocast(bfloat16)`` gives DINOv2's module with f32 weights.
Rounded to bf16: the image and the weights and bias of the patch
projection, the projection's output; the LayerNorm outputs where they
enter a product; the weights and biases of ``qkv``, ``proj``, ``w12`` and
``w3`` (cast per call from the f32 parameters, as the ResNets do) and each
of their outputs; q, k and v; the attention's output; ``silu(a)`` and its
product with ``b``.  Kept in f32: the residual stream (the projected
patches promoted where the CLS token is joined), the position table and
its resampling, the CLS and register tokens, LayerNorm's statistics and
outputs, LayerScale's product and each residual sum, the taps and
``pooled``.  Every product sums in f32.  With ``float32`` nothing is
rounded.

A block's pointwise chains run fused (``ops/vit_pointwise.py``, the CUDA
kernels of csrc/vit_pointwise.cu on the card, the plain operations on the
CPU): ``residual_ln`` does ``norm1`` and its rounding in one pass, then
LayerScale's product, the residual add, ``norm2`` and its rounding in
another, then the second LayerScale and residual add in a third;
``silu_mul`` does SiLU, its rounding and the product with ``b`` in one
pass over ``w12``'s output.  The operations, their order and their
roundings are those listed above, the LayerNorm's statistics included
(summed as PyTorch's CUDA LayerNorm sums them), so the trunk's bits are
those of the operations run one by one.

Attention is ``F.scaled_dot_product_attention`` with one backend pinned
on the card, so that one kernel name stands for it on the device trace:
FlashAttention-2 (``SDPBackend.FLASH_ATTENTION``, whose forward kernel's
name holds ``flash_fwd``) for bf16 operands, and the memory-efficient
backend (``SDPBackend.EFFICIENT_ATTENTION``) for f32 ones, which
FlashAttention does not take.  On the CPU PyTorch chooses.

Spans (utils/profiling.span), inside the caller's ``ssad.image.forward``:
``ssad.vit.embed`` (projection, tokens, positions), ``ssad.vit.blocks``
(the blocks' enqueue) and ``ssad.vit.taps`` (the final norm of the four
taps and their grids).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ssad_tpu_torch.ops.vit_pointwise import residual_ln, silu_mul
from ssad_tpu_torch.utils.profiling import span

LN_EPS = 1e-6
#: the taps' names, after blocks depth/4, depth/2, 3·depth/4 and depth
TAPS = ("layer1", "layer2", "layer3", "layer4")


def swiglu_hidden(dim: int, mlp_ratio: float) -> int:
    """DINOv2's ``SwiGLUFFNFused`` hidden width: 2/3 of dim·mlp_ratio,
    rounded up to a multiple of 8 (4096 for 1536 × 4)."""
    return (int(dim * mlp_ratio * 2 / 3) + 7) // 8 * 8


def attention_backend(device: torch.device, dtype: torch.dtype):
    """The context that pins the attention's backend on the card (module
    docstring); nothing on the CPU."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    from torch.nn.attention import SDPBackend, sdpa_kernel

    half = dtype in (torch.bfloat16, torch.float16)
    return sdpa_kernel(SDPBackend.FLASH_ATTENTION if half else SDPBackend.EFFICIENT_ATTENTION)


def _linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """``layer`` in the dtype of ``x``, weights and bias cast per call."""
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


def _ln_args(norm: nn.LayerNorm):
    """``ops.vit_pointwise``'s (weight, bias, eps) of a LayerNorm."""
    return norm.weight, norm.bias, norm.eps


class LayerScale(nn.Module):
    """One learned f32 scale a channel, ``gamma``: ``Block`` applies it to
    its branch's output in ``ops.vit_pointwise.residual_ln``."""

    def __init__(self, dim: int, init_values: float = 1.0):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init_values)))


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=True)
        self.proj = nn.Linear(dim, dim, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        qkv = _linear(x, self.qkv).view(b, n, 3, self.num_heads, c // self.num_heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)  # (B, heads, N, head dim) each
        o = F.scaled_dot_product_attention(q, k, v)
        return _linear(o.transpose(1, 2).reshape(b, n, c), self.proj)


class SwiGLU(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.w12 = nn.Linear(dim, 2 * hidden, bias=True)
        self.w3 = nn.Linear(hidden, dim, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _linear(silu_mul(_linear(x, self.w12)), self.w3)


class Block(nn.Module):
    """Pre-norm attention and SwiGLU, each with LayerScale, on an f32
    residual stream; the products run in ``dtype``."""

    def __init__(self, dim: int, num_heads: int, hidden: int, dtype: torch.dtype):
        super().__init__()
        self.compute_dtype = dtype
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, num_heads)
        self.ls1 = LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = SwiGLU(dim, hidden)
        self.ls2 = LayerScale(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        _, n = residual_ln(x, ln=_ln_args(self.norm1), dtype=dt)
        x, n = residual_ln(x, self.attn(n), self.ls1.gamma, _ln_args(self.norm2), dt)
        x, _ = residual_ln(x, self.mlp(n), self.ls2.gamma)
        return x


class VisionTransformer(nn.Module):
    """A DINOv2 trunk with registers at the given widths (tests build tiny
    ones; ``BACKBONES`` holds the published preset).  ``depth`` is a
    multiple of 4, so that the four taps fall after whole quarters."""

    def __init__(self, embed_dim: int = 1536, depth: int = 40, num_heads: int = 24,
                 mlp_ratio: float = 4.0, patch_size: int = 14, img_size: int = 518,
                 num_register_tokens: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        if depth % 4 or embed_dim % num_heads:
            raise ValueError(f"depth {depth} must be a multiple of 4 and width {embed_dim} "
                             f"a multiple of {num_heads} heads")
        self.compute_dtype = dtype
        self.patch_size = patch_size
        self.num_register_tokens = num_register_tokens
        self.grid = img_size // patch_size  # the position table's side
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + self.grid ** 2, embed_dim))
        self.register_tokens = nn.Parameter(torch.zeros(1, num_register_tokens, embed_dim))
        self.mask_token = nn.Parameter(torch.zeros(1, embed_dim))
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, embed_dim, patch_size, patch_size, bias=True)
        hidden = swiglu_hidden(embed_dim, mlp_ratio)
        self.blocks = nn.ModuleList(Block(embed_dim, num_heads, hidden, dtype)
                                    for _ in range(depth))
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.tap_blocks = tuple(depth * i // 4 for i in range(1, 5))
        self.stage_channels: Dict[str, int] = {t: embed_dim for t in TAPS}

    def positions(self, gh: int, gw: int) -> torch.Tensor:
        """(1, 1 + gh·gw, C) f32: the table's CLS row and its patch rows at
        the (gh, gw) grid."""
        pos = self.pos_embed.float()
        if (gh, gw) == (self.grid, self.grid):
            return pos
        c = pos.shape[-1]
        table = pos[:, 1:].reshape(1, self.grid, self.grid, c).permute(0, 3, 1, 2)
        patch = F.interpolate(table, size=(gh, gw), mode="bicubic", antialias=True)
        return torch.cat([pos[:, :1], patch.permute(0, 2, 3, 1).reshape(1, gh * gw, c)], dim=1)

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW images → (B, 1 + registers + h·w, C) f32 tokens."""
        proj = self.patch_embed.proj
        dt = self.compute_dtype
        p = F.conv2d(x.to(dt), proj.weight.to(dt), proj.bias.to(dt), stride=self.patch_size)
        b, _, gh, gw = p.shape
        t = torch.cat([self.cls_token.expand(b, -1, -1).float(),
                       p.flatten(2).transpose(1, 2).float()], dim=1)
        t = t + self.positions(gh, gw)
        return torch.cat([t[:, :1], self.register_tokens.expand(b, -1, -1).float(), t[:, 1:]],
                         dim=1)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """ImageNet-normalised NCHW images → (pooled (B, C) f32, {'layer1'..
        'layer4': (B, C, h, w) f32 grids})."""
        b, _, h, w = x.shape
        p = self.patch_size
        if h % p or w % p:
            raise ValueError(f"the {p}-px patches of this transformer trunk need image sides "
                             f"that are multiples of {p}, got {h}×{w}")
        with span("ssad.vit.embed"):
            t = self.embed(x)
        with span("ssad.vit.blocks"):
            taps = []
            with attention_backend(t.device, self.compute_dtype):
                for i, block in enumerate(self.blocks, start=1):
                    t = block(t)
                    if i in self.tap_blocks:
                        taps.append(t)
        with span("ssad.vit.taps"):
            normed = [self.norm(t) for t in taps]
            first = 1 + self.num_register_tokens
            feats = {name: n[:, first:].reshape(b, h // p, w // p, -1).permute(0, 3, 1, 2)
                     for name, n in zip(TAPS, normed)}
            pooled = normed[-1][:, 0]
        return pooled, feats


def init_vit_(model: VisionTransformer, generator: torch.Generator) -> None:
    """DINOv2's initial values of the tables (``init_weights``): the CLS and
    register tokens N(0, 1e-6²), the position table N(0, 0.02²) cut at ±2,
    the mask token 0; LayerNorm and LayerScale to 1 (``init_values``), the
    LayerNorm biases 0.  Convolution and dense layers are left to the
    caller (``peranet.init_model``)."""
    with torch.no_grad():
        model.cls_token.normal_(0.0, 1e-6, generator=generator)
        model.register_tokens.normal_(0.0, 1e-6, generator=generator)
        nn.init.trunc_normal_(model.pos_embed, 0.0, 0.02, generator=generator)
        model.mask_token.zero_()
        for m in model.modules():
            if isinstance(m, nn.LayerNorm):
                m.reset_parameters()
            elif isinstance(m, LayerScale):
                m.gamma.fill_(1.0)


def dinov2_vitg14_reg(dtype: torch.dtype = torch.float32) -> VisionTransformer:
    """DINOv2 ViT-g/14 with 4 registers (hubconf ``dinov2_vitg14_reg``):
    1,136,486,912 parameters."""
    return VisionTransformer(embed_dim=1536, depth=40, num_heads=24, mlp_ratio=4.0,
                             patch_size=14, img_size=518, num_register_tokens=4, dtype=dtype)


BACKBONES = {"dinov2_vitg14_reg": dinov2_vitg14_reg}
