"""Inputs made from ``--seed``: weights and images, on the device, in a few
large calls.  The same seed gives the same inputs; each use draws from a
stream of its own (``stream``), so adding one use moves no other."""

from __future__ import annotations

import math
import zlib
from typing import Dict, Tuple

import numpy as np
import torch


def stream(seed: int, tag: str) -> int:
    """A 63-bit seed for the use ``tag`` of the run seed ``seed``."""
    state = np.random.SeedSequence([int(seed) % 2**63, zlib.crc32(tag.encode())])
    return int(state.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream(seed, tag))


def _kind(key: str, shape: Tuple[int, ...]) -> str:
    if key.endswith("num_batches_tracked"):
        return "zero"
    if key.endswith("running_mean"):
        return "normal"
    if key.endswith("running_var"):
        return "uniform"
    if len(shape) >= 2:
        return "normal"
    return "uniform" if key.endswith("weight") else "normal"


def fill_state(shapes: Dict[str, Tuple[int, ...]], seed: int, device) -> Dict[str, torch.Tensor]:
    """A state dict of ``shapes``' keys, drawn on ``device``: convolutions
    He-normal (std √(2/fan_in)), dense weights N(0, 1/fan_in), dense biases
    N(0, 0.05²); BatchNorm scales U(0.8, 1.2), biases N(0, 0.05²), running
    means N(0, 0.1²), running variances U(0.5, 2); ``num_batches_tracked``
    0.  Two draws in all, one normal and one uniform, sliced per tensor."""
    kinds = {k: _kind(k, s) for k, s in shapes.items()}
    sizes = {k: math.prod(s) for k, s in shapes.items()}
    gen = generator(seed, "weights", device)
    normal = torch.randn(sum(sizes[k] for k in shapes if kinds[k] == "normal"),
                         generator=gen, device=device)
    uniform = torch.rand(sum(sizes[k] for k in shapes if kinds[k] == "uniform"),
                         generator=gen, device=device)
    out, at = {}, {"normal": 0, "uniform": 0}
    for k, shape in shapes.items():
        kind = kinds[k]
        if kind == "zero":
            out[k] = torch.zeros(shape, dtype=torch.int64, device=device)
            continue
        src = normal if kind == "normal" else uniform
        v = src[at[kind]: at[kind] + sizes[k]].view(shape)
        at[kind] += sizes[k]
        if k.endswith("running_mean"):
            v = v * 0.1
        elif k.endswith("running_var"):
            v = 0.5 + 1.5 * v
        elif len(shape) == 4:
            v = v * (2.0 / math.prod(shape[1:])) ** 0.5
        elif len(shape) == 2:
            v = v * shape[1] ** -0.5
        elif kind == "uniform":  # a BatchNorm scale
            v = 0.8 + 0.4 * v
        else:  # a bias
            v = v * 0.05
        out[k] = v.contiguous()
    return out


def images(n: int, size: int, seed: int, tag: str, device, blobs: int = 6,
           chunk: int = 128) -> torch.Tensor:
    """(n, size, size, 3) float32 in [0, 1] on ``device``: a flat colour, a
    few soft colour blobs at random places and sizes, and pixel noise, so
    that windows of one image differ as parts of a real one do.  Two draws,
    the blobs composed ``chunk`` images at a time."""
    gen = generator(seed, tag, device)
    u = torch.rand((n, 3 + blobs * 6), generator=gen, device=device)
    img = 0.05 * torch.rand((n, size, size, 3), generator=gen, device=device)
    axis = torch.arange(size, device=device, dtype=torch.float32)
    for lo in range(0, n, chunk):
        v = u[lo:lo + chunk]
        m = v.shape[0]
        cy, cx = v[:, 3:3 + blobs] * size, v[:, 3 + blobs:3 + 2 * blobs] * size
        sigma = size * (0.04 + 0.12 * v[:, 3 + 2 * blobs:3 + 3 * blobs])
        amp = (v[:, 3 + 3 * blobs:].reshape(m, blobs, 3) - 0.5) * 0.6
        gy = torch.exp(-((axis - cy[..., None]) ** 2) / (2 * sigma[..., None] ** 2))
        gx = torch.exp(-((axis - cx[..., None]) ** 2) / (2 * sigma[..., None] ** 2))
        img[lo:lo + m] += (0.25 + 0.5 * v[:, :3]).view(m, 1, 1, 3)
        img[lo:lo + m] += torch.einsum("nkh,nkw,nkc->nhwc", gy, gx, amp)
    return img.clamp_(0.0, 1.0)
