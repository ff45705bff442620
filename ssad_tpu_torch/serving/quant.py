"""Weight-only int8 quantization for serving artifacts.

Counterpart of ssad_tpu/serving/quant.py:46-89: symmetric
per-output-channel int8 on every floating tensor with at least two axes
(convolution kernels, linear weights),

    scale[c] = max(|w[c, ...]|) / 127            (float32, one per channel)
    q[c, ...] = round(w[c, ...] / scale[c])       (int8, half to even)

The JAX package's output channel is the LAST axis (HWIO kernels, IO dense
kernels); a PyTorch state dict keeps it FIRST (OIHW, out × in), so the
maximum runs over every axis but the first.  The values are the same
after the layout transpose, and so are q and scale, bit for bit.  1-D
tensors (BatchNorm scale, bias and running statistics, biases) and
integer ones stay as they are.  The artifact stores q and the scales;
``ServedScorer`` dequantizes once at load, to bf16 values on the device
(the JAX package dequantizes inside its traced program, to bf16 too).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

#: tensors with fewer axes than this stay unquantized (BN parameters, biases)
MIN_QUANT_NDIM = 2


def is_quantizable(t: torch.Tensor) -> bool:
    return t.ndim >= MIN_QUANT_NDIM and t.is_floating_point()


def quantize(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One tensor, output channel on axis 0 → (int8 q, float32 scale (C,))."""
    w = w.detach().float()
    amax = w.abs().amax(dim=tuple(range(1, w.ndim)))
    scale = torch.clamp(amax, min=torch.finfo(torch.float32).tiny) / 127.0
    q = torch.round(w / scale.view((-1,) + (1,) * (w.ndim - 1)))
    return torch.clamp(q, -127, 127).to(torch.int8), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale.view((-1,) + (1,) * (q.ndim - 1))).to(dtype)


def quantize_state_dict(state_dict: Dict[str, torch.Tensor]
                        ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(state dict with int8 in place of every quantizable tensor, their
    scales by name)."""
    out, scales = {}, {}
    for name, t in state_dict.items():
        if is_quantizable(t):
            out[name], scales[name] = quantize(t)
        else:
            out[name] = t
    return out, scales


def dequantize_state_dict(state_dict: Dict[str, torch.Tensor], scales: Dict[str, torch.Tensor],
                          dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """The float state dict back: ``dtype`` values where a scale is given,
    every other tensor unchanged."""
    return {name: dequantize(t, scales[name].to(t.device), dtype) if name in scales else t
            for name, t in state_dict.items()}
