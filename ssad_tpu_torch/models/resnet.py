"""ResNet backbones returning the pooled features and the stage taps.

Counterpart of ssad_tpu/models/resnet.py: the 7×7/s2 stem, its folded
4×4/s1 form for 32×32 inputs (``fold_2x``), ``forward_stages``, the
re-entry point after the stem's maxpool, basic blocks (ResNet-18/34) and
bottleneck blocks (ResNet-50, Wide-ResNet-50-2: 1×1 reduce, 3×3 with the
stride, 1×1 expand ×4; the inner width scaled by ``width_factor``).  Every
backbone has the same 64-channel stem, so 32×32 windows take the fused
stem kernel whatever the backbone.  The JAX
package's space-to-depth stem (``ModelConfig.stem_s2d``) computes the same
function as the 7×7/s2 conv and was a TPU layout trick; the port runs the
7×7/s2 conv whatever that field says.  Module and parameter names are torchvision's,
so a reference ``feature_extractor.*`` state dict loads with
``strict=True``.

Precision follows the JAX model.  With ``compute_dtype=bfloat16`` the
convolutions take bf16 inputs and weights (the weights stay f32
parameters and are cast per call, as Flax does), and each BatchNorm
computes its affine in f32 and rounds once to bf16 — Flax's
``_normalize`` order, (x − mean)·(rsqrt(var + eps)·scale) + bias.

In eval mode with autograd recording nothing (``inference_mode``,
``no_grad``, or no tensor requiring grad) and no torch function mode
watching the forward op by op (``one_pass``), each block's
BatchNorm → (+ shortcut) → ReLU chains and the stem's BatchNorm + ReLU
run as ``ops.bn_act`` passes: the same arithmetic in the same order, the
CUDA kernel csrc/bn_act.cu on the card (one read and one write of each
activation where the chain makes eight passes) and the chain's torch
operations on the CPU.  The projection shortcut's BatchNorm is computed
in the pass that adds it.  Training, eval with a graph recorded, and a
forward under a function mode (train/_pinning's ``Recorder`` and
``Pinned`` read and pin each ReLU, which the kernel does not expose) run
the chain module by module.

BatchNorm in training mode is Flax's ``nn.BatchNorm(momentum=0.9,
epsilon=1e-5)`` (flax/linen/normalization.py ``_compute_stats``,
``_normalize``): batch mean and variance reduced in f32 over every axis
but the channels, the variance as E[x²] − E[x]² clipped at 0, and the
running statistics updated as 0.9·running + 0.1·batch with the BIASED
variance.  PyTorch's own update (``F.batch_norm(training=True)``) uses
the unbiased variance, n/(n−1) larger, which would move every eval-mode
embedding and the memory bank away from the JAX package's.  Gradients
flow through the batch statistics by autograd.

After ``sync_batch_stats(model, group)`` (data-parallel training,
train/trainer.py) the train-mode statistics are those of the whole batch
across the group: each rank's f32 mean and mean square are averaged over
it by a differentiable all-reduce, so the backward pass sees the global
statistics too, as JAX's global-view step does.  The ranks' slices are
equal, so the average of their moments is the batch's.  Without a group
nothing changes, bit for bit.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ssad_tpu_torch.ops.bn_act import bn_act
from ssad_tpu_torch.ops.stem_pool import fold_stem_kernel

#: base width of each stage (torchvision's ``planes``)
STAGE_FILTERS = (64, 128, 256, 512)


class Conv2d(nn.Conv2d):
    """A bias-free convolution run in the dtype of its input."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weight.to(x.dtype), None)


def _group_mean(t: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(t, op=dist.ReduceOp.SUM, group=group) / dist.get_world_size(group)


def sync_batch_stats(model: nn.Module, group) -> None:
    """Reduce every FlaxBatchNorm's train-mode statistics of ``model`` over
    the ranks of ``group`` (a ``torch.distributed`` process group; None:
    each rank's own batch)."""
    for m in model.modules():
        if isinstance(m, FlaxBatchNorm):
            m.sync_group = group


class FlaxBatchNorm:
    """BatchNorm in Flax's arithmetic order, output in ``out_dtype`` (the
    compute dtype; None keeps the input's).  ``train()`` normalises by the
    batch statistics and updates the running ones; ``eval()`` reads the
    running ones."""

    out_dtype = None
    #: the process group train-mode statistics are averaged over
    #: (``sync_batch_stats``); None: this batch alone
    sync_group = None
    #: Flax's momentum: running ← MOMENTUM·running + (1 − MOMENTUM)·batch
    MOMENTUM = 0.9

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.out_dtype or x.dtype
        shape = (1, -1) + (1,) * (x.ndim - 2)
        if self.training:
            dims = (0,) + tuple(range(2, x.ndim))
            x32 = x.float()
            mean, mean_sq = x32.mean(dims), (x32 * x32).mean(dims)
            if self.sync_group is not None:
                mean, mean_sq = _group_mean(torch.stack([mean, mean_sq]), self.sync_group)
            var = torch.clamp(mean_sq - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.MOMENTUM
                self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x.float() - mean.view(shape)) * mul.view(shape)
        return (y + self.bias.view(shape)).to(dtype)

    def inference_affine(self):
        """(mean, mul, bias) of the eval-mode affine (x − mean)·mul + bias,
        mul computed as ``forward`` computes it: ``ops.bn_act``'s input."""
        return self.running_mean, torch.rsqrt(self.running_var + self.eps) * self.weight, self.bias


def one_pass(x: torch.Tensor, module: nn.Module, norms) -> bool:
    """Whether ``module``'s BatchNorm → (+ residual) → ReLU chains on input
    ``x`` run as ``ops.bn_act`` passes: every one of ``norms`` in eval mode
    with x's dtype as its output dtype, no torch function mode watching
    the operations, and autograd recording nothing (no grad mode, or
    neither x nor a parameter of ``module`` requires grad).  Otherwise
    (training, a graph being recorded, or a mode that sees each ReLU) the
    chain runs as it is."""
    if any(bn.training or bn.out_dtype not in (None, x.dtype) for bn in norms):
        return False
    if torch._C._is_torch_function_mode_enabled():
        return False
    return not torch.is_grad_enabled() or not (
        x.requires_grad or any(p.requires_grad for p in module.parameters()))


class BatchNorm2d(FlaxBatchNorm, nn.BatchNorm2d):
    def __init__(self, num_features: int, out_dtype=None):
        super().__init__(num_features, eps=1e-5, momentum=0.1)
        self.out_dtype = out_dtype


class BatchNorm1d(FlaxBatchNorm, nn.BatchNorm1d):
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
        ds = self.downsample
        if one_pass(x, self, (self.bn1, self.bn2) + (() if ds is None else (ds[1],))):
            residual = x if ds is None else ds[0](x)
            y = bn_act(self.conv1(x), self.bn1.inference_affine())
            return bn_act(self.conv2(y), self.bn2.inference_affine(), residual=residual,
                          residual_affine=None if ds is None else ds[1].inference_affine())
        residual = x if ds is None else ds(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return F.relu(y + residual)


class BottleneckBlock(nn.Module):
    """1×1 reduce → 3×3 (stride) → 1×1 expand (×4) + identity/projection
    shortcut (ResNet v1.5 bottleneck, ssad_tpu/models/resnet.py:136-175);
    ``width`` is the inner width (2·filters for wide_resnet50_2)."""

    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int, dtype: torch.dtype, width: int):
        super().__init__()
        cout = filters * self.expansion
        self.conv1 = Conv2d(cin, width, 1, 1, 0, bias=False)
        self.bn1 = BatchNorm2d(width, dtype)
        self.conv2 = Conv2d(width, width, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm2d(width, dtype)
        self.conv3 = Conv2d(width, cout, 1, 1, 0, bias=False)
        self.bn3 = BatchNorm2d(cout, dtype)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                Conv2d(cin, cout, 1, stride, 0, bias=False), BatchNorm2d(cout, dtype)
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ds = self.downsample
        if one_pass(x, self, (self.bn1, self.bn2, self.bn3) + (() if ds is None else (ds[1],))):
            residual = x if ds is None else ds[0](x)
            y = bn_act(self.conv1(x), self.bn1.inference_affine())
            y = bn_act(self.conv2(y), self.bn2.inference_affine())
            return bn_act(self.conv3(y), self.bn3.inference_affine(), residual=residual,
                          residual_affine=None if ds is None else ds[1].inference_affine())
        residual = x if ds is None else ds(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + residual)


class ResNet(nn.Module):
    """ResNet v1 with ``block`` 'basic' or 'bottleneck'; forward returns
    (pooled (B, C4) f32, {'layer1'..'layer4': NCHW maps in the compute
    dtype}).  ``stage_channels`` holds each stage's output width."""

    def __init__(self, stage_sizes=(2, 2, 2, 2), dtype: torch.dtype = torch.float32,
                 block: str = "basic", width_factor: int = 1):
        super().__init__()
        if block not in ("basic", "bottleneck"):
            raise ValueError(f"block must be 'basic' or 'bottleneck', got {block!r}")
        self.compute_dtype = dtype
        self.conv1 = Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(64, dtype)
        self.stage_channels: Dict[str, int] = {}
        cin = 64
        for stage, (blocks, filters) in enumerate(zip(stage_sizes, STAGE_FILTERS), start=1):
            layer = []
            for b in range(blocks):
                stride = 2 if stage > 1 and b == 0 else 1
                if block == "basic":
                    layer.append(BasicBlock(cin, filters, stride, dtype))
                    cin = filters
                else:
                    layer.append(BottleneckBlock(cin, filters, stride, dtype,
                                                 width=filters * width_factor))
                    cin = filters * BottleneckBlock.expansion
            setattr(self, f"layer{stage}", nn.Sequential(*layer))
            self.stage_channels[f"layer{stage}"] = cin

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
        if one_pass(x, self.bn1, (self.bn1,)):
            x = bn_act(x, self.bn1.inference_affine())
        else:
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


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Flax's ``lecun_normal`` in place: a normal truncated to ±2 of its
    scale, scaled so that the std is 1/√fan_in (fan_in: every axis but the
    output one, i.e. I·kh·kw of an OIHW conv, I of an (O, I) dense)."""
    fan_in = weight[0].numel()
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978  # std of N(0, 1) cut at ±2
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


def ResNet18(dtype: torch.dtype = torch.float32) -> ResNet:
    return ResNet((2, 2, 2, 2), dtype=dtype)


def ResNet34(dtype: torch.dtype = torch.float32) -> ResNet:
    """torchvision resnet34: basic blocks at (3, 4, 6, 3), ResNet-18's
    stage widths."""
    return ResNet((3, 4, 6, 3), dtype=dtype)


def ResNet50(dtype: torch.dtype = torch.float32) -> ResNet:
    """torchvision resnet50: bottleneck blocks at (3, 4, 6, 3), stage
    widths 256/512/1024/2048."""
    return ResNet((3, 4, 6, 3), dtype=dtype, block="bottleneck")


def WideResNet50_2(dtype: torch.dtype = torch.float32) -> ResNet:
    """torchvision wide_resnet50_2: ResNet-50 with the inner width of every
    bottleneck doubled (the PatchCore-style feature extractor)."""
    return ResNet((3, 4, 6, 3), dtype=dtype, block="bottleneck", width_factor=2)


BACKBONES = {"resnet18": ResNet18, "resnet34": ResNet34, "resnet50": ResNet50,
             "wide_resnet50_2": WideResNet50_2, "wide_resnet50": WideResNet50_2}


def make_backbone(arch: str, dtype: torch.dtype = torch.float32) -> ResNet:
    if arch not in BACKBONES:
        raise ValueError(
            f"unknown backbone '{arch}' (resnet18 | resnet34 | resnet50 | wide_resnet50_2)"
        )
    return BACKBONES[arch](dtype)
