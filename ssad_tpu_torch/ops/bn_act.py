"""Inference BatchNorm → (+ residual) → ReLU in one pass.

The eval-mode chain of the trunk's blocks (models/resnet.py): the
BatchNorm's affine in f32, rounded once to the compute dtype, then the
residual add in that dtype (the shortcut itself, or a second BatchNorm of
the projection's output, rounded before the add), then the ReLU.  No TPU
kernel corresponds: XLA fused this into the convolutions.

* ``bn_act_cuda`` launches the Hopper kernel of csrc/bn_act.cu, for CUDA
  tensors in bfloat16 or float32: one read of the activation (and of the
  residual) and one write, with the chain's bits.
* ``bn_act_plain`` is the chain in plain PyTorch, operation by operation
  as ``FlaxBatchNorm.forward`` computes it, then ``+`` and ``F.relu``.  It
  serves CPU tensors, and the tests and the on-card check hold the kernel
  against it.
* ``bn_act`` dispatches on the tensor's device.  There is no fallback: on
  a CUDA tensor the kernel runs or the call raises.

An ``affine`` is (mean, mul, bias), f32 vectors of the channels, for
(x − mean)·mul + bias with mul = rsqrt(var + eps)·weight
(``FlaxBatchNorm.inference_affine``).  Activations are (N, C, ...) in the
input's dtype.  The kernel takes channels-last memory (the NHWC views the
port feeds cuDNN come back so) and NCHW-contiguous memory; the residual
must share the input's layout, and the output has it too.  It moves 16
bytes at a time, so it refuses views off a 16-byte boundary and element
counts that are not a multiple of 8 (bf16) or 4 (f32).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ssad_tpu_torch.ops import _cuda

DTYPES = {torch.bfloat16: 0, torch.float32: 1}  # csrc/bn_act.cu's dtype codes


def _normalize(x: torch.Tensor, affine: Sequence[torch.Tensor]) -> torch.Tensor:
    mean, mul, bias = affine
    shape = (1, -1) + (1,) * (x.ndim - 2)
    y = (x.float() - mean.view(shape)) * mul.view(shape)
    return (y + bias.view(shape)).to(x.dtype)


def bn_act_plain(x: torch.Tensor, affine: Sequence[torch.Tensor], relu: bool = True,
                 residual: Optional[torch.Tensor] = None,
                 residual_affine: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """Plain PyTorch version: the eval-mode chain, one operation a pass."""
    _check_args(x, affine, residual, residual_affine)
    y = _normalize(x, affine)
    if residual is not None:
        if residual_affine is not None:
            residual = _normalize(residual, residual_affine)
        y = y + residual
    return F.relu(y) if relu else y


def _check_args(x, affine, residual, residual_affine) -> None:
    if x.ndim < 2:
        raise ValueError(f"expected (N, C, ...) activations, got {tuple(x.shape)}")
    c = x.shape[1]
    for name, aff in (("affine", affine), ("residual_affine", residual_affine)):
        if aff is not None and (len(aff) != 3 or any(t.shape != (c,) for t in aff)):
            raise ValueError(f"{name} must be three ({c},) vectors (mean, mul, bias)")
    if residual_affine is not None and residual is None:
        raise ValueError("residual_affine needs a residual")
    if residual is not None and residual.shape != x.shape:
        raise ValueError(f"residual {tuple(residual.shape)} does not match x {tuple(x.shape)}")


def _layouts(t: torch.Tensor) -> set:
    """The dense layouts ``t``'s memory is in, size-1 dimensions aside:
    'channels_last' (C innermost, then the spatial dims, then N) and
    'contiguous' (NCHW)."""
    def dense(order):
        expected = 1
        for d in reversed(order):
            if t.shape[d] != 1 and t.stride(d) != expected:
                return False
            expected *= t.shape[d]
        return True

    spatial = list(range(2, t.ndim))
    out = set()
    if dense([0] + spatial + [1]):
        out.add("channels_last")
    if dense([0, 1] + spatial):
        out.add("contiguous")
    return out


def bn_act_cuda(x: torch.Tensor, affine: Sequence[torch.Tensor], relu: bool = True,
                residual: Optional[torch.Tensor] = None,
                residual_affine: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """Launch the CUDA kernel (csrc/bn_act.cu) on the current stream; the
    output has x's dtype, shape and strides."""
    _check_args(x, affine, residual, residual_affine)
    if x.device.type != "cuda":
        raise ValueError(f"bn_act_cuda needs CUDA tensors, got {x.device}")
    if x.dtype not in DTYPES:
        raise ValueError(f"the CUDA bn_act kernel takes bfloat16 or float32, got {x.dtype}")
    tensors = [x] if residual is None else [x, residual]
    if residual is not None and (residual.dtype != x.dtype or residual.device != x.device):
        raise ValueError(f"residual ({residual.dtype}, {residual.device}) differs from x "
                         f"({x.dtype}, {x.device})")
    layouts = set.intersection(*(_layouts(t) for t in tensors))
    if not layouts:
        raise ValueError("bn_act_cuda takes channels-last or NCHW-contiguous activations, the "
                         f"residual in x's layout; got strides {[t.stride() for t in tensors]}")
    inner = 1 if "channels_last" in layouts else math.prod(x.shape[2:])
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    vector = 16 // x.element_size()
    if x.numel() % vector or any(t.data_ptr() % 16 for t in tensors + [out]):
        raise ValueError(f"bn_act_cuda takes 16-byte-aligned activations of a multiple of "
                         f"{vector} {x.dtype} elements; got {x.numel()} at offsets "
                         f"{[t.data_ptr() % 16 for t in tensors]}")
    vecs = [v.to(x.device, torch.float32).contiguous() for v in affine]
    rvecs = ([None] * 3 if residual_affine is None else
             [v.to(x.device, torch.float32).contiguous() for v in residual_affine])
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    device = x.device.index if x.device.index is not None else torch.cuda.current_device()
    status = _kernel_fn()(
        x.data_ptr(), ptr(residual), out.data_ptr(), *(ptr(v) for v in vecs),
        *(ptr(v) for v in rvecs), x.numel(), x.shape[1], inner, DTYPES[x.dtype], int(relu),
        device, torch.cuda.current_stream(x.device).cuda_stream)
    _cuda.check(status, "bn_act_cuda")
    bn_act_cuda.launches += 1
    return out


#: launches of the CUDA kernel since the last reset (one per call)
bn_act_cuda.launches = 0


def _kernel_fn():
    return _cuda.bind("bn_act", "ssad_bn_act",
                      [ctypes.c_void_p] * 9 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong]
                      + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def bn_act(x: torch.Tensor, affine: Sequence[torch.Tensor], relu: bool = True,
           residual: Optional[torch.Tensor] = None,
           residual_affine: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """CUDA tensors → the kernel; CPU tensors → the plain version."""
    if x.device.type == "cuda":
        return bn_act_cuda(x, affine, relu, residual, residual_affine)
    if x.device.type == "cpu":
        return bn_act_plain(x, affine, relu, residual, residual_affine)
    raise ValueError(f"activations on {x.device}: bn_act runs on a CUDA device or on the CPU")
