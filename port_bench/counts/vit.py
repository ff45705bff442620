"""Work counts of PeraNet on a DINOv2 trunk (``reference/vit.py``'s widths),
2 FLOPs per multiply-add.

A verdict: the patch projection, per block the ``qkv``, attention (q kᵀ
and p v), ``proj``, ``w12`` and ``w3`` products over every token, the
head's dense layers (``counts/model.head_macs``) and its row's k-NN
products.  LayerNorm, LayerScale, the softmax, SiLU and the residual sums
are left out (a few operations an element, under 0.5 % here).  At 448²:
1,029 tokens, 2.593 TFLOP.

The attention function of one call (one block over a batch): 4·B·H·N²·d
operations (q kᵀ and p v), and its bf16 q, k and v read once and its
output written once, 2 bytes × 4·B·N·C: whatever implements it."""

from __future__ import annotations

from typing import Tuple

from port_bench.counts import kernels, model
from port_bench.reference.vit import ARCHS


def tokens(backbone: str, h: int, w: int) -> int:
    """Tokens a block runs for one h × w image: CLS, registers, patches."""
    a = ARCHS[backbone]
    return 1 + a["registers"] + (h // a["patch"]) * (w // a["patch"])


def trunk_macs(backbone: str, h: int, w: int) -> int:
    """Multiply-adds of one image through the patch projection and every
    block."""
    a = ARCHS[backbone]
    c, hidden, p, heads = a["embed_dim"], a["hidden"], a["patch"], a["num_heads"]
    n = tokens(backbone, h, w)
    block = (n * c * 3 * c  # qkv
             + 2 * heads * n * n * (c // heads)  # q kᵀ and p v
             + n * c * c  # proj
             + n * c * 2 * hidden  # w12
             + n * hidden * c)  # w3
    return (h // p) * (w // p) * c * 3 * p * p + a["depth"] * block


def verdict_flops(cfg: dict, h: int, w: int, bank_rows: int) -> float:
    """One image verdict: trunk, head and its row's k-NN products."""
    width = ARCHS[cfg["backbone"]]["embed_dim"]
    head = model.head_macs([width] * 4, cfg["layer_outputs"], cfg["latent_space_layers"],
                           cfg["latent_dim"], cfg["num_classes"])
    return (2.0 * (trunk_macs(cfg["backbone"], h, w) + head)
            + kernels.knn(1, bank_rows, cfg["latent_dim"])[0])


def attention(batch: int, backbone: str, h: int, w: int) -> Tuple[float, float]:
    """(operations, bytes) of one block's attention over ``batch`` images."""
    a = ARCHS[backbone]
    n, c, heads = tokens(backbone, h, w), a["embed_dim"], a["num_heads"]
    return float(4 * batch * heads * n * n * (c // heads)), float(2 * 4 * batch * n * c)
