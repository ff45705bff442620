"""PeraNet on DINOv2's ViT-g/14 with registers, in plain PyTorch, eval mode.

The trunk is DINOv2's (facebookresearch/dinov2,
``dinov2/models/vision_transformer.py`` ``DinoVisionTransformer`` as
``hubconf.py`` ``dinov2_vitg14_reg`` builds it: ``vit_giant2``,
``ffn_layer="swiglufused"``, 4 registers, ``interpolate_antialias=True``,
``interpolate_offset=0.0``, ``block_chunks=0``), written from that code and
the papers (arXiv 2304.07193, 2309.16588); the head is PeraNet's
(``reference/peranet.py``).  State-dict keys are DINOv2's under
``feature_extractor.`` and the head's ``concatenator`` / ``latent_space`` /
``classifier``.  Images are (B, H, W, 3), ImageNet-normalised, their sides
multiples of 14; no 64-px upsampling (that rule is the ResNets').

* tokens: the 14 × 14 / stride 14 patch convolution with bias, flattened
  row-major; the CLS token first; the position table added (its CLS row as
  it is, its 37 × 37 patch rows resampled by antialiased bicubic
  interpolation to the image's grid, unchanged at a square 37 × 37 grid);
  the 4 register tokens inserted after the CLS token, with no position
  (``prepare_tokens_with_masks``, ``interpolate_pos_encoding``);
* 40 blocks: ``x + γ1 ⊙ proj(attn(LN1(x)))``, then ``x + γ2 ⊙
  w3(silu(a) ⊙ b)`` with ``a, b = w12(LN2(x))`` split in halves; LayerNorm
  eps 1e-6; attention written out as softmax(q kᵀ / 8) v over 24 heads of
  64, every token to every token;
* taps ``layer1..layer4``: the final LayerNorm of the patch tokens after
  blocks 10, 20, 30 and 40 as (B, C, h, w) grids
  (``get_intermediate_layers(n=[9, 19, 29, 39], reshape=True, norm=True)``);
  the pooled features are the CLS token of the last, normalised.

Departures from DINOv2's code: none in the function.  The forward runs
``block`` images at a time so that the attention's (heads, N, N) scores
fit; images do not interact, so the blocks change nothing.

Every convolution and product, the attention's two among them, goes
through ``Precision.operand`` on both operands: float32 (identity) for the
reference, fp8 for the control.  Sums run in float32 with TF32 off
(``exact_f32``).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from port_bench.reference.peranet import PeraNetReference, Precision, exact_f32

#: backbone → its published widths (hubconf.py / vit_giant2)
ARCHS = {
    "dinov2_vitg14_reg": dict(embed_dim=1536, depth=40, num_heads=24, hidden=4096, patch=14,
                              grid=37, registers=4),
}
LN_EPS = 1e-6


def head_shapes(in_dim: int, latent_space_layers: int, latent_dim: int,
                num_classes: int) -> Dict[str, Tuple[int, ...]]:
    """PeraNet's head keys and shapes, as ``peranet.state_shapes`` lists them."""
    shapes: Dict[str, Tuple[int, ...]] = {}

    def bn(key, c):
        for name in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{key}.{name}"] = (c,)
        shapes[f"{key}.num_batches_tracked"] = ()

    shapes["concatenator.0.weight"] = (latent_dim, in_dim)
    bn("concatenator.1", latent_dim)
    for i in range(latent_space_layers - 2):
        shapes[f"latent_space.{i}.0.weight"] = (latent_dim, latent_dim)
        bn(f"latent_space.{i}.1", latent_dim)
    n = latent_space_layers - 2
    shapes[f"latent_space.{n}.weight"] = (latent_dim, latent_dim)
    shapes[f"latent_space.{n}.bias"] = (latent_dim,)
    bn(f"latent_space.{n + 1}", latent_dim)
    shapes["classifier.weight"] = (num_classes, latent_dim)
    shapes["classifier.bias"] = (num_classes,)
    return shapes


def state_shapes(backbone: str, layer_outputs: Sequence[str] = ("layer2", "layer3"),
                 latent_space_layers: int = 5, latent_dim: int = 512,
                 num_classes: int = 4) -> Dict[str, Tuple[int, ...]]:
    """Every key of the PeraNet state dict on ``backbone`` and its shape, in
    DINOv2's order: the weights the benchmark draws for both the port and
    this reference."""
    a = ARCHS[backbone]
    c, hidden, p = a["embed_dim"], a["hidden"], a["patch"]
    fe = "feature_extractor"
    shapes: Dict[str, Tuple[int, ...]] = {
        f"{fe}.cls_token": (1, 1, c),
        f"{fe}.pos_embed": (1, 1 + a["grid"] ** 2, c),
        f"{fe}.register_tokens": (1, a["registers"], c),
        f"{fe}.mask_token": (1, c),
        f"{fe}.patch_embed.proj.weight": (c, 3, p, p),
        f"{fe}.patch_embed.proj.bias": (c,),
    }
    for i in range(a["depth"]):
        k = f"{fe}.blocks.{i}"
        shapes.update({
            f"{k}.norm1.weight": (c,), f"{k}.norm1.bias": (c,),
            f"{k}.attn.qkv.weight": (3 * c, c), f"{k}.attn.qkv.bias": (3 * c,),
            f"{k}.attn.proj.weight": (c, c), f"{k}.attn.proj.bias": (c,),
            f"{k}.ls1.gamma": (c,),
            f"{k}.norm2.weight": (c,), f"{k}.norm2.bias": (c,),
            f"{k}.mlp.w12.weight": (2 * hidden, c), f"{k}.mlp.w12.bias": (2 * hidden,),
            f"{k}.mlp.w3.weight": (c, hidden), f"{k}.mlp.w3.bias": (c,),
            f"{k}.ls2.gamma": (c,),
        })
    shapes[f"{fe}.norm.weight"] = (c,)
    shapes[f"{fe}.norm.bias"] = (c,)
    shapes.update(head_shapes(c * (len(layer_outputs) + 1), latent_space_layers, latent_dim,
                              num_classes))
    return shapes


class ViTPeraNetReference(PeraNetReference):
    """The eval-mode forward of one PeraNet on a DINOv2 trunk from its state
    dict, ``block`` images at a time."""

    def __init__(self, state: Dict[str, torch.Tensor], backbone: str = "dinov2_vitg14_reg",
                 layer_outputs: Sequence[str] = ("layer2", "layer3"),
                 latent_space_layers: int = 5, precision: Precision = Precision(),
                 block: int = 8):
        self.sd = {k: v.float() for k, v in state.items() if v.is_floating_point()}
        self.arch = ARCHS[backbone]
        self.taps = tuple(sorted(layer_outputs))
        self.latent_layers = latent_space_layers
        self.p = precision
        self.block = block

    # -- pieces -----------------------------------------------------------------

    def _ln(self, x, key: str):
        return F.layer_norm(x, (x.shape[-1],), self.sd[key + ".weight"], self.sd[key + ".bias"],
                            eps=LN_EPS)

    def _attention(self, x, key: str):
        b, n, c = x.shape
        heads = self.arch["num_heads"]
        d = c // heads
        qkv = self._dense(x, key + ".qkv").view(b, n, 3, heads, d).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * d ** -0.5, qkv[1], qkv[2]
        scores = self.p.operand(q) @ self.p.operand(k).transpose(-2, -1)
        o = self.p.operand(scores.softmax(dim=-1)) @ self.p.operand(v)
        return self._dense(o.transpose(1, 2).reshape(b, n, c), key + ".proj")

    def _positions(self, gh: int, gw: int):
        pos = self.sd["feature_extractor.pos_embed"]
        m = self.arch["grid"]
        if (gh, gw) == (m, m):
            return pos
        c = pos.shape[-1]
        table = pos[:, 1:].reshape(1, m, m, c).permute(0, 3, 1, 2)
        patch = F.interpolate(table, size=(gh, gw), mode="bicubic", antialias=True)
        return torch.cat([pos[:, :1], patch.permute(0, 2, 3, 1).reshape(1, gh * gw, c)], dim=1)

    # -- forward ----------------------------------------------------------------

    def trunk(self, x: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """NCHW float32 → (pooled CLS token, {'layer1'..'layer4'} grids)."""
        fe = "feature_extractor."
        a, sd = self.arch, self.sd
        b = x.shape[0]
        t = F.conv2d(self.p.operand(x), self.p.operand(sd[fe + "patch_embed.proj.weight"]),
                     stride=a["patch"]) + sd[fe + "patch_embed.proj.bias"].view(1, -1, 1, 1)
        gh, gw = t.shape[2], t.shape[3]
        t = t.flatten(2).transpose(1, 2)
        t = torch.cat([sd[fe + "cls_token"].expand(b, -1, -1), t], dim=1) + self._positions(gh, gw)
        t = torch.cat([t[:, :1], sd[fe + "register_tokens"].expand(b, -1, -1), t[:, 1:]], dim=1)
        normed = []
        for i in range(a["depth"]):
            k = f"{fe}blocks.{i}"
            t = t + sd[k + ".ls1.gamma"] * self._attention(self._ln(t, k + ".norm1"), k + ".attn")
            h1, h2 = self._dense(self._ln(t, k + ".norm2"), k + ".mlp.w12").chunk(2, dim=-1)
            t = t + sd[k + ".ls2.gamma"] * self._dense(F.silu(h1) * h2, k + ".mlp.w3")
            if (i + 1) % (a["depth"] // 4) == 0:
                normed.append(self._ln(t, fe + "norm"))
        first = 1 + a["registers"]
        feats = {f"layer{j}": n[:, first:].reshape(b, gh, gw, -1).permute(0, 3, 1, 2)
                 for j, n in enumerate(normed, start=1)}
        return normed[-1][:, 0], feats

    def head(self, feats: Dict[str, torch.Tensor], pooled: torch.Tensor):
        """Tap means + pooled → concat head → latent MLP → (logits, embeddings)."""
        h = torch.cat([feats[t].mean(dim=(2, 3)) for t in self.taps] + [pooled], dim=1)
        h = self._bn(self._dense(h, "concatenator.0"), "concatenator.1")
        for i in range(self.latent_layers - 2):
            h = F.relu(self._bn(self._dense(h, f"latent_space.{i}.0"), f"latent_space.{i}.1"))
        n = self.latent_layers - 2
        emb = self._bn(self._dense(h, f"latent_space.{n}"), f"latent_space.{n + 1}")
        return self._dense(emb, "classifier"), emb

    def forward(self, x_normalized: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, H, W, 3) normalised images → (logits (B, C), embeddings (B, D))."""
        x = x_normalized.float().permute(0, 3, 1, 2)
        logits, emb = [], []
        with exact_f32():
            for lo in range(0, x.shape[0], self.block):
                pooled, feats = self.trunk(x[lo:lo + self.block])
                lg, e = self.head(feats, pooled)
                logits.append(lg)
                emb.append(e)
        return torch.cat(logits), torch.cat(emb)
