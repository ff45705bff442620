"""The served pipeline in plain PyTorch: normality embeddings, the 70/30
fit, k-NN cosine scores, and the patch maps (windows → PeraNet → k-NN →
blur ⊗ upsample).  Written from the definitions the port's docstrings
cite (the reference repository's models.py:352-370, tools.py:351-399,
functional.py:77-82), not from the port's code."""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from port_bench.reference.peranet import PeraNetReference, Precision, exact_f32, normalize

#: the threshold's validation share of the normality rows
VAL_SHARE = 0.3


def windows(x: torch.Tensor, dim: int, stride: int) -> torch.Tensor:
    """(B, H, W, C) → (B·P, dim, dim, C), windows in row-major order per
    image (``Tensor.unfold``, as the reference repository cuts them)."""
    b, _, _, c = x.shape
    p = x.unfold(1, dim, stride).unfold(2, dim, stride)  # (B, oh, ow, C, dim, dim)
    return p.permute(0, 1, 2, 4, 5, 3).reshape(-1, dim, dim, c)


def embed(model: PeraNetReference, images: torch.Tensor, patch: dict = None,
          block: int = 2048) -> torch.Tensor:
    """Raw [0, 1] images → embeddings: one row per image, or with ``patch``
    ({"dim", "stride"}) one per window, ``block`` inputs per forward."""
    x = normalize(images)
    if patch is not None:
        x = windows(x, patch["dim"], patch["stride"])
    return torch.cat([model.forward(x[lo:lo + block])[1] for lo in range(0, x.shape[0], block)])


def split(m: int, seed: int) -> Tuple[torch.Tensor, int]:
    """The 70/30 split: a permutation of the m normality rows from a CPU
    ``torch.Generator`` seeded with ``seed``, and how many of its first
    rows are the validation part (round(0.3·m), at least 1)."""
    perm = torch.randperm(m, generator=torch.Generator().manual_seed(seed))
    return perm, max(int(round(m * VAL_SHARE)), 1)


def knn_scores(queries: torch.Tensor, bank: torch.Tensor, k: int,
               precision: Precision = Precision(), block: int = 8192) -> torch.Tensor:
    """1 − mean of the k largest cosine similarities to the bank's rows."""
    def unit(x):
        x = x.float()
        return x / torch.clamp(torch.linalg.vector_norm(x, dim=1, keepdim=True), min=1e-12)

    b = precision.operand(unit(bank))
    out = []
    with exact_f32():
        for lo in range(0, queries.shape[0], block):
            sims = precision.operand(unit(queries[lo:lo + block])) @ b.T
            out.append(1.0 - torch.topk(sims, k, dim=1).values.mean(dim=1))
    return torch.cat(out)


def fit(normality: torch.Tensor, k: int, seed: int,
        precision: Precision = Precision()) -> Tuple[torch.Tensor, float]:
    """(bank, threshold): the bank is the 70 %, the threshold the largest
    score of the 30 % against it (models.py:352-361)."""
    perm, n_val = split(normality.shape[0], seed)
    perm = perm.to(normality.device)
    bank = normality[perm[n_val:]]
    val = knn_scores(normality[perm[:n_val]], bank, k, precision)
    return bank, float(val.max())


def _gaussian_taps(ksize: int = 7) -> torch.Tensor:
    sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8  # torchvision's default for ksize
    x = torch.arange(ksize, dtype=torch.float64) - (ksize - 1) / 2
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).float()


def blur_upsample(maps: torch.Tensor, size: int, ksize: int = 7) -> torch.Tensor:
    """(B, s, s) → (B, size, size): gaussian blur (ksize 7, torchvision's
    sigma, reflect padding) → ReLU → bilinear upsampling with half-pixel
    centres (tools.py:394-399)."""
    k = _gaussian_taps(ksize).to(maps.device)
    pad = ksize // 2
    x = maps.float()[:, None]
    with exact_f32():
        x = F.conv2d(F.pad(x, (0, 0, pad, pad), mode="reflect"), k.view(1, 1, ksize, 1))
        x = F.conv2d(F.pad(x, (pad, pad, 0, 0), mode="reflect"), k.view(1, 1, 1, ksize))
    x = F.interpolate(torch.relu(x), size=(size, size), mode="bilinear", align_corners=False)
    return x[:, 0]


def patch_maps(model: PeraNetReference, images: torch.Tensor, bank: torch.Tensor, k: int,
               dim: int, stride: int, precision: Precision = Precision()) -> torch.Tensor:
    """Raw [0, 1] (B, H, W, 3) images → (B, H, W) anomaly maps."""
    emb = embed(model, images, {"dim": dim, "stride": stride})
    side = int(math.isqrt(emb.shape[0] // images.shape[0]))
    scores = knn_scores(emb, bank, k, precision).reshape(images.shape[0], side, side)
    return blur_upsample(scores, images.shape[1])
