"""Image primitives on channels-last float tensors in [0, 1].

Counterparts of ssad_tpu/ops/image.py: normalisation, resizes and the
gaussian blur (:29-121), the augmentation ops of the pretext synthesizer
(:127-426) and the anomaly-map blur ⊗ upsample (:429-524).  The public
layout stays the JAX package's (H, W, C) / (B, H, W, C); the model
converts to NCHW inside.

The augmentation ops take an image or a batch.  Their random parameters
are arguments (a scalar, or one value per image of a batch): the caller
draws them (data/synthetic.py).  Where the JAX package moves pixels by
one-hot matmuls or roll-accumulate passes (TPU workarounds) these use
gathers, but every rounding the result depends on is kept: bf16 tent
weights summed in f32 with the intermediate rounded to bf16, and shear
shifts that are round() of f32 products.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ssad_tpu_torch.constants import IMAGENET_MEAN, IMAGENET_STD
from ssad_tpu_torch.utils.device import tf32_off


@functools.lru_cache(maxsize=16)
def _imagenet_stats(dtype: torch.dtype, device: torch.device):
    """(mean, std) in ``dtype`` on ``device``, made once: later calls copy
    nothing from the host (the synthesizer's batch runs with no host
    sync)."""
    def make(v):  # through f32, as numpy constants reach JAX
        return torch.tensor(v, dtype=torch.float32).to(device, dtype)

    return make(IMAGENET_MEAN), make(IMAGENET_STD)


def normalize_imagenet(img: torch.Tensor) -> torch.Tensor:
    """(x - mean) / std over the trailing channel axis (reference
    datasets.py:430-433)."""
    mean, std = _imagenet_stats(img.dtype, img.device)
    return (img - mean) / std


def denormalize_imagenet(img: torch.Tensor) -> torch.Tensor:
    mean, std = _imagenet_stats(img.dtype, img.device)
    return img * std + mean


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


# --- colour adjustments (torchvision semantics) ------------------------------


def _per_image(v, img: torch.Tensor):
    """A scalar stays as it is; one value per image of a (B, H, W, C)
    batch is shaped to broadcast against it."""
    if isinstance(v, torch.Tensor) and v.ndim:
        return v.reshape(v.shape + (1,) * 3)
    return v


@functools.lru_cache(maxsize=16)
def _gray_weights(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The luma weights rounded to ``dtype`` (as the JAX package rounds
    them), made once per dtype and device."""
    return torch.tensor([0.299, 0.587, 0.114], dtype=torch.float32).to(device, dtype)


def _rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    return torch.sum(img * _gray_weights(img.dtype, img.device), dim=-1, keepdim=True)


def adjust_brightness(img: torch.Tensor, factor) -> torch.Tensor:
    return torch.clamp(img * factor, 0.0, 1.0)


def adjust_contrast(img: torch.Tensor, factor) -> torch.Tensor:
    # the grey mean accumulates in f32 (a bf16 sum over 64k pixels loses
    # most of its precision)
    mean = _rgb_to_gray(img).float().mean(dim=(-3, -2, -1), keepdim=True).to(img.dtype)
    return torch.clamp(img * factor + mean * (1.0 - factor), 0.0, 1.0)


def adjust_saturation(img: torch.Tensor, factor) -> torch.Tensor:
    gray = _rgb_to_gray(img)
    return torch.clamp(img * factor + gray * (1.0 - factor), 0.0, 1.0)


#: the six orders of (brightness, contrast, saturation), in the JAX
#: package's order (ssad_tpu/ops/image.py:174)
JITTER_ORDERS = ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0))


def color_jitter(img: torch.Tensor, factors: torch.Tensor, order) -> torch.Tensor:
    """ColorJitter with torchvision semantics, from given draws: factors
    (..., 3) = (brightness, contrast, saturation), each rounded to the
    image's dtype, applied in the order JITTER_ORDERS[order] (reference
    CPP.jitter_transforms, datasets.py:44-47, applied at :391).  A batch
    takes one row of factors and one order per image."""
    f = factors.to(img.dtype)
    fns = (
        functools.partial(adjust_brightness, factor=_per_image(f[..., 0], img)),
        functools.partial(adjust_contrast, factor=_per_image(f[..., 1], img)),
        functools.partial(adjust_saturation, factor=_per_image(f[..., 2], img)),
    )
    order = torch.as_tensor(order, device=img.device)
    # JITTER_ORDERS is lexicographic: its first op is order // 2, the other
    # two follow in ascending order or swapped by order % 2
    first = order // 2
    low = (first == 0).long()  # the smaller of the two left
    high = 2 - (first == 2).long()
    second = torch.where(order % 2 == 0, low, high)
    x = img
    for op in (first, second, 3 - first - second):
        op = _per_image(op, img)
        x = torch.where(op == 0, fns[0](x), torch.where(op == 1, fns[1](x), fns[2](x)))
    return x


# --- affine -----------------------------------------------------------------


def affine_nearest(img: torch.Tensor, angle_deg, scale, fill: float = 0.0) -> torch.Tensor:
    """Rotate-and-scale of one (H, W, C) image about its centre, nearest
    sampling (torchvision RandomAffine's default): output pixel p reads
    input ``centre + R(-θ)·(p - centre)/s``.  The oracle of
    ``random_affine``'s tests; the synthesizer runs ``random_affine``."""
    h, w = img.shape[0], img.shape[1]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    theta = torch.as_tensor(angle_deg, dtype=torch.float32) * (math.pi / 180.0)
    cos_t = torch.cos(theta) / scale
    sin_t = torch.sin(theta) / scale
    yy = torch.arange(h, dtype=torch.float32, device=img.device)[:, None] - cy
    xx = torch.arange(w, dtype=torch.float32, device=img.device)[None, :] - cx
    ix = torch.round(cos_t * xx + sin_t * yy + cx).long()
    iy = torch.round(-sin_t * xx + cos_t * yy + cy).long()
    valid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    out = img[iy.clamp(0, h - 1), ix.clamp(0, w - 1)]
    return torch.where(valid[..., None], out, torch.full_like(out, fill))


def shear_lines(img: torch.Tensor, shifts: torch.Tensor, axis: int,
                max_shift: int | None = None) -> torch.Tensor:
    """Shift each line of a (B, H, W, C) batch by an integer, zero fill.
    axis=2 shifts along the width, one shift per row: out[b, r, c] =
    img[b, r, c - shifts[b, r]]; axis=1 along the height, one shift per
    column: out[b, r, c] = img[b, r - shifts[b, c], c].  Lines whose
    |shift| exceeds ``max_shift`` come out zero, as the JAX package's
    static shift range leaves them."""
    b, h, w, c = img.shape
    size = img.shape[axis]
    pos = torch.arange(size, device=img.device)
    if axis == 2:
        src = pos[None, None, :] - shifts[:, :, None]
    else:
        src = pos[None, :, None] - shifts[:, None, :]
    valid = (src >= 0) & (src < size)
    if max_shift is not None:
        ok = shifts.abs() <= max_shift
        valid &= ok[:, :, None] if axis == 2 else ok[:, None, :]
    src = src.clamp(0, size - 1).expand(b, h, w)
    out = torch.gather(img, axis, src[..., None].expand(b, h, w, c))
    return torch.where(valid[..., None], out, torch.zeros((), dtype=img.dtype, device=img.device))


def rotate_small_angle(img: torch.Tensor, angle_deg, max_degrees: float) -> torch.Tensor:
    """Rotation about the centre by the exact 3-shear decomposition
    R(θ) = Shx(-tan θ/2) · Shy(sin θ) · Shx(-tan θ/2) with integer shifts
    round() of f32 products; ``max_degrees`` bounds the shifts as in the
    JAX package.  (B, H, W, C) with one angle per image, or one image."""
    if img.ndim == 3:
        return rotate_small_angle(img[None], torch.as_tensor(angle_deg).reshape(1),
                                  max_degrees)[0]
    h, w = img.shape[1], img.shape[2]
    theta = angle_deg.to(device=img.device, dtype=torch.float32) * (math.pi / 180.0)
    a = -torch.tan(theta / 2.0)
    bsin = torch.sin(theta)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    rows = torch.arange(h, dtype=torch.float32, device=img.device) - cy
    cols = torch.arange(w, dtype=torch.float32, device=img.device) - cx
    sx1 = torch.round(a[:, None] * rows).long()  # column shift per row
    sy = torch.round(bsin[:, None] * cols).long()  # row shift per column
    mx = int(math.floor(math.tan(math.radians(max_degrees) / 2.0) * max(cy, cx) + 0.5))
    my = int(math.floor(math.sin(math.radians(max_degrees)) * max(cy, cx) + 0.5))
    out = shear_lines(img, sx1, axis=2, max_shift=mx)
    out = shear_lines(out, sy, axis=1, max_shift=my)
    return shear_lines(out, sx1, axis=2, max_shift=mx)


def apply_separable(img: torch.Tensor, m_r: torch.Tensor, m_c: torch.Tensor) -> torch.Tensor:
    """out[..., i, k, c] = Σ_{j,l} m_r[..., i, j] · img[..., j, l, c] ·
    m_c[..., k, l] for (..., H, W, C) images, with the JAX package's
    roundings: weights and image in bf16, each pass summed in f32 (TF32
    off) and rounded to bf16, the result cast back to the image's dtype."""
    bf = torch.bfloat16
    x = img.to(bf).float()
    with tf32_off():
        tmp = torch.einsum("...ij,...jlc->...ilc", m_r.to(bf).float(), x).to(bf).float()
        out = torch.einsum("...kl,...jlc->...jkc", m_c.to(bf).float(), tmp)
    return out.to(bf).to(img.dtype)


def _tent_matrix(n: int, scale: torch.Tensor) -> torch.Tensor:
    """(..., n, n) bilinear weights of a zoom about the centre: row i
    interpolates the source coordinate c + (i - c)/scale (f32)."""
    c = (n - 1) / 2.0
    i = torch.arange(n, dtype=torch.float32, device=scale.device)
    src = c + (i - c) / scale[..., None]
    return torch.clamp(1.0 - torch.abs(src[..., :, None] - i), min=0.0)


def scale_about_center(img: torch.Tensor, scale) -> torch.Tensor:
    """Bilinear zoom about the image centre, separable (apply_separable's
    roundings); one scale per image of a batch, or one for one image."""
    scale = torch.as_tensor(scale, dtype=torch.float32, device=img.device)
    h, w = img.shape[-3], img.shape[-2]
    return apply_separable(img, _tent_matrix(h, scale), _tent_matrix(w, scale))


def random_affine(img: torch.Tensor, angle_deg, scale, degrees: float = 3.0) -> torch.Tensor:
    """RandomAffine(degrees, scale) from given draws (reference
    datasets.py:220-222): the bf16 tent zoom, then the 3-shear rotation,
    clipped to [0, 1].  Not torchvision's affine: it follows the JAX
    package's ``random_affine``."""
    dtype = img.dtype
    out = scale_about_center(img, scale).to(dtype)
    out = rotate_small_angle(out, torch.as_tensor(angle_deg, device=img.device), degrees)
    return torch.clamp(out, 0.0, 1.0).to(dtype)


# --- misc -------------------------------------------------------------------


def mean_color(img: torch.Tensor) -> torch.Tensor:
    """Mean RGB over the two spatial axes, accumulated in f32: (..., 3)."""
    return img.float().mean(dim=(-3, -2))


def color_cosine_similarity(a_mean: torch.Tensor, b_mean: torch.Tensor,
                            eps: float = 1e-12) -> torch.Tensor:
    """Cosine similarity of mean-RGB vectors over the last axis (reference
    check_color_similarity, dataset_generator.py:147-159)."""
    num = torch.sum(a_mean * b_mean, dim=-1)
    den = torch.sqrt(torch.sum(a_mean**2, dim=-1)) * torch.sqrt(torch.sum(b_mean**2, dim=-1))
    return num / (den + eps)


# --- anomaly maps -----------------------------------------------------------


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
