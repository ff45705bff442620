"""Image primitives on channels-last float tensors in [0, 1].

Counterparts of ssad_tpu/ops/image.py:29-121 (normalisation, resizes,
gaussian blur) and :429-524 (the anomaly-map blur ⊗ upsample).  The
public layout stays the JAX package's (H, W, C) / (B, H, W, C); the model
converts to NCHW inside.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ssad_tpu_torch.constants import IMAGENET_MEAN, IMAGENET_STD
from ssad_tpu_torch.utils.device import tf32_off


def normalize_imagenet(img: torch.Tensor) -> torch.Tensor:
    """(x - mean) / std over the trailing channel axis (reference
    datasets.py:430-433)."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=img.dtype, device=img.device)
    std = torch.tensor(IMAGENET_STD, dtype=img.dtype, device=img.device)
    return (img - mean) / std


def resize_nearest(img: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Nearest resize of the two leading spatial axes of an (H, W, ...)
    tensor, with jax.image.resize's source index floor((i + ½)·in/out)
    (the index math runs in float32, as jax's does).  Integer upscale
    factors are a plain repeat, which that rule reduces to."""
    h, w = size
    ih, iw = img.shape[0], img.shape[1]
    if h % ih == 0 and w % iw == 0 and (h > ih or w > iw):
        out = img.repeat_interleave(h // ih, dim=0)
        return out.repeat_interleave(w // iw, dim=1)
    for axis, (n_in, n_out) in enumerate(((ih, h), (iw, w))):
        if n_in == n_out:
            continue
        offsets = (torch.arange(n_out, dtype=torch.float32) + 0.5) * n_in / n_out
        idx = torch.floor(offsets).to(torch.int64).clamp_(max=n_in - 1)
        img = img.index_select(axis, idx.to(img.device))
    return img


def resize_bilinear(img: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Half-pixel-centres bilinear resize of the two leading spatial axes
    of an (H, W) or (H, W, C) tensor (F.interpolate, align_corners=False;
    for upsampling this is jax.image.resize's renormalised triangle)."""
    x = img if img.ndim == 3 else img[..., None]
    x = F.interpolate(x.permute(2, 0, 1)[None], size=size, mode="bilinear", align_corners=False)
    x = x[0].permute(1, 2, 0)
    return x if img.ndim == 3 else x[..., 0]


def torchvision_default_sigma(ksize: int) -> float:
    """Sigma used by torchvision when none is given (gaussian_blur docs)."""
    return 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8


def _gaussian_kernel1d(ksize: int, sigma: float) -> np.ndarray:
    """float64 taps, normalised to sum 1."""
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2.0
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def gaussian_blur(img: torch.Tensor, ksize: int = 7, sigma: float | None = None) -> torch.Tensor:
    """Separable gaussian blur with reflect padding (no repeated edge) of
    (B, H, W, C) maps, as torchvision's gaussian_blur (reference
    tools.py:397: ksize 7, default sigma).  Needs H, W > ksize // 2."""
    if sigma is None:
        sigma = torchvision_default_sigma(ksize)
    c = img.shape[-1]
    pad = ksize // 2
    k = torch.tensor(_gaussian_kernel1d(ksize, float(sigma)), dtype=img.dtype, device=img.device)
    x = img.permute(0, 3, 1, 2)
    x = F.conv2d(F.pad(x, (0, 0, pad, pad), mode="reflect"),
                 k.view(1, 1, ksize, 1).expand(c, 1, ksize, 1), groups=c)
    x = F.conv2d(F.pad(x, (pad, pad, 0, 0), mode="reflect"),
                 k.view(1, 1, 1, ksize).expand(c, 1, 1, ksize), groups=c)
    return x.permute(0, 2, 3, 1)


def upsample_anomaly_maps_staged(maps: torch.Tensor, target_size: int = 256) -> torch.Tensor:
    """The literal pipeline, blur → ReLU → bilinear (reference
    tools.py:394-399): the oracle of the fused path, and the right one for
    maps that can be negative."""
    m = maps[:, 0] if maps.ndim == 4 else maps
    m = torch.relu(gaussian_blur(m[..., None].float(), ksize=7))
    return torch.stack([resize_bilinear(x, (target_size, target_size)) for x in m])[..., 0]


def _reflect_blur_matrix(s: int, ksize: int, sigma: float) -> np.ndarray:
    """(s, s) float64 matrix of the reflect-padded gaussian blur along one
    axis: row i is the kernel centred at i, indices folded as reflect
    padding folds them (more than once when s < ksize)."""
    k = _gaussian_kernel1d(ksize, sigma)
    pad = ksize // 2

    def fold(j: int) -> int:
        if s == 1:
            return 0
        period = 2 * s - 2
        j %= period
        return period - j if j >= s else j

    mat = np.zeros((s, s), np.float64)
    for i in range(s):
        for t in range(ksize):
            mat[i, fold(i + t - pad)] += k[t]
    return mat


def _bilinear_matrix(s: int, target: int) -> np.ndarray:
    """(target, s) weights of half-pixel-centres bilinear upsampling,
    computed in float32 as jax.image.resize computes them: triangle
    weights of sample (t + ½)·s/target − ½, renormalised to sum 1 (which
    clamps the samples past the border)."""
    f32 = np.float32
    inv_scale = f32(1.0 / (target / s))
    sample = (np.arange(target, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(s, dtype=f32)[:, None])
    w = np.maximum(f32(0), f32(1) - x)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000 * np.finfo(f32).eps, w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= s - 0.5)
    return np.where(inside[None, :], w, 0).astype(f32).T


@functools.lru_cache(maxsize=16)
def _blur_upsample_matrix(s: int, target: int, ksize: int = 7) -> np.ndarray:
    """(target, s) float32 operator of one axis: reflect-padded gaussian
    blur, then bilinear upsampling."""
    blur = _reflect_blur_matrix(s, ksize, torchvision_default_sigma(ksize))
    return (_bilinear_matrix(s, target).astype(np.float64) @ blur).astype(np.float32)


def upsample_anomaly_maps_fused(maps: torch.Tensor, target_size: int = 256) -> torch.Tensor:
    """Blur → ReLU → bilinear for NON-NEGATIVE (B, s, s) maps as two f32
    products (TF32 off) per image with the (target, s) operator, then the
    ReLU.  For maps ≥ 0 the mid-pipeline ReLU is a no-op, so the whole
    pipeline is linear per axis."""
    m = maps.to(torch.float32)
    op = torch.from_numpy(_blur_upsample_matrix(m.shape[-1], target_size)).to(m.device)
    with tf32_off():
        tmp = torch.einsum("ij,bjl->bil", op, m)
        out = torch.einsum("bil,kl->bik", tmp, op)
    return torch.relu(out)


def upsample_anomaly_maps(maps: torch.Tensor, target_size: int = 256) -> torch.Tensor:
    """Blur(k=7) → ReLU → bilinear upsample of anomaly maps (reference
    tools.py:394-399): (B, s, s) or (B, 1, s, s) → (B, target, target).
    Scores are ≥ 0 by construction, so this takes the fused operator."""
    m = maps[:, 0] if maps.ndim == 4 else maps
    return upsample_anomaly_maps_fused(m, target_size)
