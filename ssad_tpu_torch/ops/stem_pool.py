"""Fused folded stem + BatchNorm + ReLU + maxpool for 32×32 patches.

Counterpart of ssad_tpu/ops/stem_pool.py (fold_stem_kernel :76,
bn_affine :89, folded_stem_affine :95, stem_pool_xla :245, the Pallas
kernel :284-391 and the dispatch :453).  For 32×32 inputs the
reference's nearest-×2 upsample + 7×7/s2 stem is one 4×4/s1 conv with
pairwise-summed weights and padding (2, 1); BatchNorm runs in inference
mode, so it is the affine ``y·scale' + bias'``.  The 3×3/s2/pad-1 maxpool
of post-ReLU values may pad with zeros.

* ``stem_pool_cuda`` launches the Hopper kernel of csrc/stem_pool.cu
  (replacing the TPU kernel ``_stem_pool_kernel``), for CUDA tensors: the
  conv as a bf16 tensor-core product, in row bands whose conv output
  stays in shared memory.
* ``stem_pool_plain`` is the same function in plain PyTorch (im2col, an
  f32 matmul with TF32 off, affine, ReLU, maxpool, one rounding to the
  input's dtype).  It serves CPU tensors, and the tests and the on-card
  check hold the kernel against it.
* ``stem_pool`` dispatches on the tensor's device.  There is no
  fallback: on a CUDA tensor the kernel runs or the call raises.

Layouts are the JAX package's: patches (N, 32, 32, 3) and the output
(N, 16, 16, F), channels last.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ssad_tpu_torch.ops import _cuda
from ssad_tpu_torch.utils.device import tf32_off

PATCH = 32  # the input side the fold is exact for
STEM_FEATURES = 64  # csrc/stem_pool.cu kChannels


def fold_stem_kernel(kernel7: torch.Tensor) -> torch.Tensor:
    """(7, 7, 3, F) HWIO stem weights → the folded (4, 4, 3, F) kernel
    for nearest-×2-upsampled inputs: w' = [w0, w1+w2, w3+w4, w5+w6] per
    spatial axis."""
    w = kernel7
    w = torch.stack([w[0], w[1] + w[2], w[3] + w[4], w[5] + w[6]], dim=0)
    return torch.stack(
        [w[:, 0], w[:, 1] + w[:, 2], w[:, 3] + w[:, 4], w[:, 5] + w[:, 6]], dim=1
    )


def bn_affine(scale, bias, mean, var, eps: float = 1e-5):
    """Inference-mode BatchNorm folded to (scale', bias')."""
    s = scale / torch.sqrt(var + eps)
    return s, bias - mean * s


def folded_stem_affine(state_dict: dict, eps: float = 1e-5, prefix: str = "feature_extractor."):
    """(folded (4, 4, 3, F) kernel, BN scale', BN bias'), all f32, from a
    PeraNet state dict: ``conv1.weight`` (OIHW, 7×7) and ``bn1.*``
    running statistics of the backbone."""
    w7 = state_dict[prefix + "conv1.weight"].float().permute(2, 3, 1, 0)  # OIHW → HWIO
    scale, bias = bn_affine(
        state_dict[prefix + "bn1.weight"].float(),
        state_dict[prefix + "bn1.bias"].float(),
        state_dict[prefix + "bn1.running_mean"].float(),
        state_dict[prefix + "bn1.running_var"].float(),
        eps,
    )
    return fold_stem_kernel(w7), scale, bias


def _check_args(x: torch.Tensor, k4: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor):
    if x.ndim != 4 or tuple(x.shape[1:]) != (PATCH, PATCH, 3):
        raise ValueError(f"expected patches (N, 32, 32, 3), got {tuple(x.shape)}")
    if k4.numel() != 48 * k4.shape[-1]:
        raise ValueError(f"expected a (4, 4, 3, F) or (48, F) kernel, got {tuple(k4.shape)}")
    f = k4.shape[-1]
    if scale.shape != (f,) or bias.shape != (f,):
        raise ValueError(
            f"scale/bias must be ({f},), got {tuple(scale.shape)} and {tuple(bias.shape)}"
        )


def _im2col_4x4(x: torch.Tensor) -> torch.Tensor:
    """(N, 32, 32, 3) → (N·1024, 48), padding (2, 1) per axis, tap order
    (ky, kx, c): the (4, 4, 3, F) → (48, F) reshape of the kernel."""
    n = x.shape[0]
    xp = F.pad(x, (0, 0, 2, 1, 2, 1))
    cols = [xp[:, ky : ky + PATCH, kx : kx + PATCH, :] for ky in range(4) for kx in range(4)]
    return torch.cat(cols, dim=-1).reshape(n * PATCH * PATCH, 48)


def stem_pool_plain(x: torch.Tensor, k4: torch.Tensor, scale: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: (N, 32, 32, 3) → (N, 16, 16, F) in x's dtype.

    The kernel is cast to x's dtype (fold in f32 first, as the JAX
    package does), products and sums run in f32, the affine and ReLU in
    f32, and the pooled result is rounded once (rounding is monotone, so
    pooling before it equals pooling the rounded conv output)."""
    _check_args(x, k4, scale, bias)
    f = k4.shape[-1]
    n = x.shape[0]
    w = k4.reshape(48, f).to(x.dtype).float()
    with tf32_off():
        y = _im2col_4x4(x).float() @ w
    y = torch.relu(y * scale.float() + bias.float())
    y = y.reshape(n, PATCH, PATCH, f).permute(0, 3, 1, 2)
    y = F.max_pool2d(y, 3, 2, 1)  # −inf padding; equal to zero padding post-ReLU
    return y.permute(0, 2, 3, 1).contiguous().to(x.dtype)


def stem_pool_cuda(x: torch.Tensor, k4: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel (csrc/stem_pool.cu) on the current stream:
    bf16 patches → bf16 (N, 16, 16, 64)."""
    _check_args(x, k4, scale, bias)
    if x.device.type != "cuda":
        raise ValueError(f"stem_pool_cuda needs CUDA tensors, got {x.device}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"the CUDA stem kernel takes bfloat16 patches, got {x.dtype}")
    f = k4.shape[-1]
    if f != STEM_FEATURES:
        raise ValueError(f"the CUDA stem kernel has {STEM_FEATURES} output channels, got {f}")
    x = x.contiguous()
    # n-major (64, 48) weights: a lane's B fragment pairs neighbouring taps
    wt = k4.reshape(48, f).t().to(x.device, torch.bfloat16).contiguous()
    s = scale.to(x.device, torch.float32).contiguous()
    b = bias.to(x.device, torch.float32).contiguous()
    n = x.shape[0]
    out = torch.empty((n, PATCH // 2, PATCH // 2, f), dtype=torch.bfloat16, device=x.device)
    if n == 0:
        return out
    device = x.device.index if x.device.index is not None else torch.cuda.current_device()
    status = _kernel_fn()(x.data_ptr(), wt.data_ptr(), s.data_ptr(), b.data_ptr(), out.data_ptr(),
                          n, device, torch.cuda.current_stream(x.device).cuda_stream)
    _cuda.check(status, "stem_pool_cuda")
    stem_pool_cuda.launches += 1
    return out


#: launches of the CUDA kernel since the last reset (one per call)
stem_pool_cuda.launches = 0


def _kernel_fn():
    return _cuda.bind("stem_pool", "ssad_stem_pool",
                      [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p])


def stem_blocks_per_sm(device: torch.device) -> int:
    """Resident blocks of the stem kernel per SM (the CUDA occupancy
    calculator); for the on-card records."""
    fn = _cuda.bind("stem_pool", "ssad_stem_pool_occupancy",
                    [ctypes.c_int, ctypes.POINTER(ctypes.c_int)])
    blocks = ctypes.c_int(0)
    index = device.index if device.index is not None else torch.cuda.current_device()
    _cuda.check(fn(index, ctypes.byref(blocks)), "stem_blocks_per_sm")
    return blocks.value


def stem_pool(x: torch.Tensor, k4: torch.Tensor, scale: torch.Tensor,
              bias: torch.Tensor) -> torch.Tensor:
    """CUDA tensors → the kernel; CPU tensors → the plain version."""
    if x.device.type == "cuda":
        return stem_pool_cuda(x, k4, scale, bias)
    if x.device.type == "cpu":
        return stem_pool_plain(x, k4, scale, bias)
    raise ValueError(f"patches on {x.device}: the stem runs on a CUDA device or on the CPU")
