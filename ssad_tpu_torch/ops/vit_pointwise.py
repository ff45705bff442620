"""The transformer trunk's pointwise chains (models/vit.py) in two passes.

* ``residual_ln``: ``x' = x + gamma ⊙ y`` (LayerScale's product and the
  residual add on the f32 stream) and ``n = LayerNorm(x').to(dtype)`` (the
  next branch's input), either half optional: the LayerNorm alone before
  the attention, both after it, the residual alone after the SwiGLU.
* ``silu_mul``: ``silu(a) * b`` over the two halves ``a, b`` of the SwiGLU's
  ``w12`` output.

No TPU kernel corresponds: XLA fused these chains into the products on the
TPU.

Each has three forms, as ``ops.bn_act`` has:

* ``*_cuda`` launches the Hopper kernel of csrc/vit_pointwise.cu on the
  current stream: one read of each input and one write of each output,
  with the plain version's bits on the card: the same IEEE operations in
  the same order, the LayerNorm's statistics summed as PyTorch's CUDA
  LayerNorm sums them (tests/test_torch_vit_pointwise_cuda.py holds this
  for the PyTorch the card runs).
* ``*_plain`` is the chain in plain PyTorch, operation by operation as the
  trunk computed it before the kernels.  It serves CPU tensors, and the
  tests hold the kernels against it on the card.
* ``residual_ln`` and ``silu_mul`` dispatch on the tensor's device.  There
  is no fallback: on a CUDA tensor the kernel runs or the call raises.

The stream ``x`` is float32; ``y``, ``n`` and ``silu_mul``'s tensors are
bfloat16 or float32.  Tensors are contiguous, 16-byte aligned, with a last
dimension that is a multiple of 8 (up to 1,536, ViT-g's width, for
``residual_ln``, whose rows a warp holds in registers); anything else is
refused.  The kernels compute no gradient, so they refuse inputs that
autograd would record.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ssad_tpu_torch.ops import _cuda

DTYPES = {torch.bfloat16: 0, torch.float32: 1}  # csrc/vit_pointwise.cu's dtype codes
#: residual_ln's widest row: 12 vectors of 4 f32 values in each lane of a warp
MAX_WIDTH = 1536

#: a LayerNorm's (weight, bias, eps)
LayerNormArgs = Tuple[torch.Tensor, torch.Tensor, float]


def residual_ln_plain(x: torch.Tensor, y: Optional[torch.Tensor] = None,
                      gamma: Optional[torch.Tensor] = None,
                      ln: Optional[LayerNormArgs] = None,
                      dtype: Optional[torch.dtype] = None
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version: ``(x', n)``, with ``x'`` = x where no ``y`` is
    given and ``n`` None where no ``ln``."""
    _check_residual_args(x, y, gamma, ln, dtype)
    if y is not None:
        x = x + gamma * y  # a bf16 y is promoted to f32 by the f32 gamma
    if ln is None:
        return x, None
    weight, bias, eps = ln
    return x, F.layer_norm(x, (x.shape[-1],), weight, bias, eps).to(dtype)


def silu_mul_plain(h: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``silu(a) * b``, ``a, b = h.chunk(2, -1)``."""
    _check_silu_args(h)
    a, b = h.chunk(2, dim=-1)
    return F.silu(a) * b


def _check_residual_args(x, y, gamma, ln, dtype) -> None:
    if y is None and ln is None:
        raise ValueError("residual_ln needs a branch output y, a LayerNorm, or both")
    if x.dtype != torch.float32 or x.ndim < 1:
        raise ValueError(f"the residual stream must be float32, got {x.dtype}")
    c = x.shape[-1]
    if (y is None) != (gamma is None):
        raise ValueError("the residual needs both y and gamma")
    if y is not None and (y.shape != x.shape or gamma.shape != (c,)):
        raise ValueError(f"y {tuple(y.shape)} and gamma {tuple(gamma.shape)} do not match "
                         f"x {tuple(x.shape)}")
    if ln is not None:
        if dtype not in DTYPES:
            raise ValueError(f"the LayerNorm's output dtype must be one of "
                             f"{list(DTYPES)}, got {dtype}")
        if len(ln) != 3 or any(t.shape != (c,) for t in ln[:2]):
            raise ValueError(f"ln must be ({c},) weight and bias and eps")
    tensors = [t for t in (x, y, gamma) + (tuple(ln[:2]) if ln else ()) if t is not None]
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"residual_ln's tensors lie on several devices: "
                         f"{sorted({str(t.device) for t in tensors})}")


def _check_silu_args(h) -> None:
    if h.ndim < 1 or h.shape[-1] % 2:
        raise ValueError(f"silu_mul needs an even last dimension, got {tuple(h.shape)}")


def _check_launchable(what: str, tensors: Sequence[torch.Tensor], width: int,
                      max_width: Optional[int] = None) -> None:
    if width % 8 or (max_width is not None and width > max_width):
        limit = "" if max_width is None else f" up to {max_width}"
        raise ValueError(f"{what} takes widths that are multiples of 8{limit}, got {width}")
    if any(not t.is_contiguous() or t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{what} takes contiguous, 16-byte-aligned tensors; got strides "
                         f"{[t.stride() for t in tensors]} at offsets "
                         f"{[t.data_ptr() % 16 for t in tensors]}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise ValueError(f"{what} computes no gradient: call it under torch.no_grad() or "
                         "inference_mode, or on tensors that need none")
    if tensors[0].device.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {tensors[0].device}")


def _device_and_stream(t: torch.Tensor):
    device = t.device.index if t.device.index is not None else torch.cuda.current_device()
    return device, torch.cuda.current_stream(t.device).cuda_stream


def residual_ln_cuda(x: torch.Tensor, y: Optional[torch.Tensor] = None,
                     gamma: Optional[torch.Tensor] = None,
                     ln: Optional[LayerNormArgs] = None,
                     dtype: Optional[torch.dtype] = None
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the CUDA kernel (csrc/vit_pointwise.cu) on the current stream;
    ``x'`` is a new tensor (where ``y`` is given), ``n`` has ``dtype``."""
    _check_residual_args(x, y, gamma, ln, dtype)
    if y is not None and y.dtype not in DTYPES:
        raise ValueError(f"the CUDA residual_ln kernel takes a bfloat16 or float32 y, "
                         f"got {y.dtype}")
    if y is not None and ln is not None and y.dtype != dtype:
        raise ValueError(f"y ({y.dtype}) and the LayerNorm's output ({dtype}) must share a "
                         "dtype")
    code = DTYPES[y.dtype if y is not None else dtype]
    params = [t for t in (gamma,) + (tuple(ln[:2]) if ln else ()) if t is not None]
    if any(t.dtype != torch.float32 for t in params):
        raise ValueError(f"gamma and the LayerNorm's weight and bias must be float32, got "
                         f"{[t.dtype for t in params]}")
    width = x.shape[-1]
    inputs = [t for t in (x, y) if t is not None] + params
    _check_launchable("residual_ln_cuda", inputs, width, MAX_WIDTH)
    x_out = torch.empty_like(x) if y is not None else None
    n = torch.empty(x.shape, dtype=dtype, device=x.device) if ln is not None else None
    rows = x.numel() // width if width else 0
    if rows:
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        weight, bias, eps = ln if ln is not None else (None, None, 0.0)
        status = _residual_ln_fn()(
            x.data_ptr(), ptr(y), ptr(gamma), ptr(weight), ptr(bias), ptr(x_out), ptr(n),
            rows, width, eps, code, *_device_and_stream(x))
        _cuda.check(status, "residual_ln_cuda")
        residual_ln_cuda.launches += 1
    return (x if x_out is None else x_out), n


#: launches of the CUDA kernel since the last reset (one per call)
residual_ln_cuda.launches = 0


def silu_mul_cuda(h: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel (csrc/vit_pointwise.cu) on the current stream;
    the output is contiguous, (..., hidden) in h's dtype."""
    _check_silu_args(h)
    if h.dtype not in DTYPES:
        raise ValueError(f"the CUDA silu_mul kernel takes bfloat16 or float32, got {h.dtype}")
    hidden = h.shape[-1] // 2
    _check_launchable("silu_mul_cuda", [h], hidden)
    out = torch.empty(h.shape[:-1] + (hidden,), dtype=h.dtype, device=h.device)
    rows = out.numel() // hidden if hidden else 0
    if rows:
        status = _silu_mul_fn()(h.data_ptr(), out.data_ptr(), rows, hidden, DTYPES[h.dtype],
                                *_device_and_stream(h))
        _cuda.check(status, "silu_mul_cuda")
        silu_mul_cuda.launches += 1
    return out


#: launches of the CUDA kernel since the last reset (one per call)
silu_mul_cuda.launches = 0


def _residual_ln_fn():
    return _cuda.bind("vit_pointwise", "ssad_residual_ln",
                      [ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float]
                      + [ctypes.c_int] * 2 + [ctypes.c_void_p])


def _silu_mul_fn():
    return _cuda.bind("vit_pointwise", "ssad_silu_mul",
                      [ctypes.c_void_p] * 2 + [ctypes.c_longlong] + [ctypes.c_int] * 3
                      + [ctypes.c_void_p])


def residual_ln(x: torch.Tensor, y: Optional[torch.Tensor] = None,
                gamma: Optional[torch.Tensor] = None, ln: Optional[LayerNormArgs] = None,
                dtype: Optional[torch.dtype] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """CUDA tensors → the kernel; CPU tensors → the plain version."""
    if x.device.type == "cuda":
        return residual_ln_cuda(x, y, gamma, ln, dtype)
    if x.device.type == "cpu":
        return residual_ln_plain(x, y, gamma, ln, dtype)
    raise ValueError(f"tensors on {x.device}: residual_ln runs on a CUDA device or on the CPU")


def silu_mul(h: torch.Tensor) -> torch.Tensor:
    """CUDA tensors → the kernel; CPU tensors → the plain version."""
    if h.device.type == "cuda":
        return silu_mul_cuda(h)
    if h.device.type == "cpu":
        return silu_mul_plain(h)
    raise ValueError(f"tensors on {h.device}: silu_mul runs on a CUDA device or on the CPU")
