"""ResNet-18 backbone returning the pooled features and the stage taps.

Counterpart of ssad_tpu/models/resnet.py:25-133, :178-258: the 7×7/s2
stem, its folded 4×4/s1 form for 32×32 inputs (``fold_2x``), and
``forward_stages``, the re-entry point after the stem's maxpool.  Module
and parameter names are torchvision's, so a reference
``feature_extractor.*`` state dict loads with ``strict=True``.

Precision follows the JAX model.  With ``compute_dtype=bfloat16`` the
convolutions take bf16 inputs and weights (the weights stay f32
parameters and are cast per call, as Flax does), and each BatchNorm
computes its inference affine in f32 and rounds once to bf16 — Flax's
``_normalize`` order, (x − mean)·(rsqrt(var + eps)·scale) + bias.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ssad_tpu_torch.ops.stem_pool import fold_stem_kernel

#: output channels of each stage
STAGE_CHANNELS = {"layer1": 64, "layer2": 128, "layer3": 256, "layer4": 512}


class Conv2d(nn.Conv2d):
    """A bias-free convolution run in the dtype of its input."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weight.to(x.dtype), None)


class _FlaxBatchNorm:
    """Inference BatchNorm in Flax's arithmetic order, output in
    ``out_dtype`` (the compute dtype; None keeps the input's).  Training
    mode waits for the training slice."""

    out_dtype = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "training-mode BatchNorm is not ported yet; call .eval() first"
            )
        dtype = self.out_dtype or x.dtype
        shape = (1, -1) + (1,) * (x.ndim - 2)
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = (x.float() - self.running_mean.view(shape)) * mul.view(shape)
        return (y + self.bias.view(shape)).to(dtype)


class BatchNorm2d(_FlaxBatchNorm, nn.BatchNorm2d):
    def __init__(self, num_features: int, out_dtype=None):
        super().__init__(num_features, eps=1e-5, momentum=0.1)
        self.out_dtype = out_dtype


class BatchNorm1d(_FlaxBatchNorm, nn.BatchNorm1d):
    def __init__(self, num_features: int, out_dtype=None):
        super().__init__(num_features, eps=1e-5, momentum=0.1)
        self.out_dtype = out_dtype


class BasicBlock(nn.Module):
    """Two 3×3 convs + identity/projection shortcut (ResNet v1 basic).
    The 1×1 projection has Flax's SAME padding, which is 0 for a 1×1
    kernel at any input size."""

    def __init__(self, cin: int, cout: int, stride: int, dtype: torch.dtype):
        super().__init__()
        self.conv1 = Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm2d(cout, dtype)
        self.conv2 = Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(cout, dtype)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                Conv2d(cin, cout, 1, stride, 0, bias=False), BatchNorm2d(cout, dtype)
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return F.relu(y + residual)


class ResNet(nn.Module):
    """ResNet v1 with basic blocks; forward returns (pooled (B, C4) f32,
    {'layer1'..'layer4': NCHW maps in the compute dtype})."""

    def __init__(self, stage_sizes=(2, 2, 2, 2), dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.conv1 = Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(64, dtype)
        cin = 64
        for stage, (blocks, cout) in enumerate(
            zip(stage_sizes, STAGE_CHANNELS.values()), start=1
        ):
            layer = []
            for block in range(blocks):
                stride = 2 if stage > 1 and block == 0 else 1
                layer.append(BasicBlock(cin, cout, stride, dtype))
                cin = cout
            setattr(self, f"layer{stage}", nn.Sequential(*layer))

    def folded_stem_weight(self) -> torch.Tensor:
        """The 4×4/s1 kernel equal to nearest-×2 upsampling followed by the
        7×7/s2 stem (w' = [w0, w1+w2, w3+w4, w5+w6] per spatial axis),
        summed in f32 from the same parameter
        (ssad_tpu/models/resnet.py:54-65)."""
        w = self.conv1.weight.float().permute(2, 3, 1, 0)  # OIHW → HWIO
        return fold_stem_kernel(w).permute(3, 2, 0, 1)

    def forward(
        self, x: torch.Tensor, stem_fold_2x: bool = False
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """NCHW images → (pooled, taps).  ``stem_fold_2x`` runs the folded
        stem on 32×32 inputs: 4×4/s1 with padding (2, 1)."""
        x = x.to(self.compute_dtype)
        if stem_fold_2x:
            w = self.folded_stem_weight().to(x.dtype)
            x = F.conv2d(F.pad(x, (2, 1, 2, 1)), w)
        else:
            x = self.conv1(x)
        x = F.relu(self.bn1(x))
        x = F.max_pool2d(x, 3, 2, 1)  # implicit −inf padding, as in Flax
        return self.forward_stages(x)

    def forward_stages(self, x: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """layer1..layer4 and the global pool from the stem's pooled
        output (NCHW; a channels-last view of NHWC data is taken as is)."""
        x = x.to(self.compute_dtype)
        feats: Dict[str, torch.Tensor] = {}
        for stage in range(1, 5):
            x = getattr(self, f"layer{stage}")(x)
            feats[f"layer{stage}"] = x
        # jnp.mean of a bf16 map: f32 sum, rounded back to the map's dtype
        pooled = x.float().mean(dim=(2, 3)).to(x.dtype).float()
        return pooled, feats


def ResNet18(dtype: torch.dtype = torch.float32) -> ResNet:
    return ResNet((2, 2, 2, 2), dtype=dtype)


def make_backbone(arch: str, dtype: torch.dtype = torch.float32) -> ResNet:
    if arch == "resnet18":
        return ResNet18(dtype)
    raise ValueError(
        f"backbone {arch!r} is not ported yet (resnet18 only); the other "
        "backbones are queued in ROADMAP.md"
    )
