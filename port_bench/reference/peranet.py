"""PeraNet in plain PyTorch: a ResNet trunk (He et al. 2015; the wide
bottleneck of Zagoruyko & Komodakis 2016 as torchvision's
``wide_resnet50_2``), the tap means and pooled features concatenated, the
latent MLP and the classifier (the reference repository's
``src/self_supervised/models.py:21-146``), in eval mode.

State-dict keys are torchvision's under ``feature_extractor.`` and the
head's ``concatenator`` / ``latent_space`` / ``classifier``.  Images are
(B, H, W, 3), ImageNet-normalised; inputs under 64 px are upsampled to 64
by nearest neighbour first (models.py:218-219), so a 32×32 window runs the
7×7/s2 stem on its ×2 upsampled copy.

Every convolution and product goes through ``Precision.operand`` on both
operands: float32 (identity) for the reference, fp8 for the control.
Sums run in float32 with TF32 off (``exact_f32``).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

#: backbone → (block, blocks per stage, inner-width factor)
ARCHS = {
    "resnet18": ("basic", (2, 2, 2, 2), 1),
    "resnet34": ("basic", (3, 4, 6, 3), 1),
    "resnet50": ("bottleneck", (3, 4, 6, 3), 1),
    "wide_resnet50_2": ("bottleneck", (3, 4, 6, 3), 2),
}
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
BN_EPS = 1e-5
FP8_MAX = 448.0  # largest finite float8_e4m3fn


class Precision:
    """Float32: operands pass unchanged."""

    name = "float32"

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        return t


class Fp8(Precision):
    """fp8 (e4m3) operands with one scale per tensor (its largest magnitude
    maps to 448), products summed in float32: the precision a tensor-core
    fp8 product computes in."""

    name = "fp8_e4m3"

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        scale = t.abs().amax().clamp(min=1e-30) / FP8_MAX
        return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


PRECISIONS = {"float32": Precision, "fp8_e4m3": Fp8}


STAGE_FILTERS = (64, 128, 256, 512)


def state_shapes(backbone: str, layer_outputs: Sequence[str] = ("layer2", "layer3"),
                 latent_space_layers: int = 5, latent_dim: int = 512,
                 num_classes: int = 4) -> Dict[str, Tuple[int, ...]]:
    """Every key of a PeraNet state dict and its shape, in torchvision's
    order: the weights the benchmark draws for both the port and this
    reference."""
    block, stages, factor = ARCHS[backbone]
    shapes: Dict[str, Tuple[int, ...]] = {}

    def bn(key, c):
        for name in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{key}.{name}"] = (c,)
        shapes[f"{key}.num_batches_tracked"] = ()

    fe = "feature_extractor"
    shapes[f"{fe}.conv1.weight"] = (64, 3, 7, 7)
    bn(f"{fe}.bn1", 64)
    cin, widths = 64, {}
    for stage, (blocks, filters) in enumerate(zip(stages, STAGE_FILTERS), start=1):
        for b in range(blocks):
            key, stride = f"{fe}.layer{stage}.{b}", 2 if stage > 1 and b == 0 else 1
            if block == "basic":
                cout = filters
                convs = [("conv1", cout, cin, 3), ("conv2", cout, cout, 3)]
            else:
                inner, cout = filters * factor, filters * 4
                convs = [("conv1", inner, cin, 1), ("conv2", inner, inner, 3),
                         ("conv3", cout, inner, 1)]
            for i, (name, o, c, k) in enumerate(convs, start=1):
                shapes[f"{key}.{name}.weight"] = (o, c, k, k)
                bn(f"{key}.bn{i}", o)
            if stride != 1 or cin != cout:
                shapes[f"{key}.downsample.0.weight"] = (cout, cin, 1, 1)
                bn(f"{key}.downsample.1", cout)
            cin = cout
        widths[f"layer{stage}"] = cin
    in_dim = sum(widths[t] for t in layer_outputs) + widths["layer4"]
    shapes["concatenator.0.weight"] = (latent_dim, in_dim)
    bn("concatenator.1", latent_dim)
    for i in range(latent_space_layers - 2):
        shapes[f"latent_space.{i}.0.weight"] = (latent_dim, latent_dim)
        bn(f"latent_space.{i}.1", latent_dim)
    n = latent_space_layers - 2
    shapes[f"latent_space.{n}.weight"] = (latent_dim, latent_dim)
    shapes[f"latent_space.{n}.bias"] = (latent_dim,)
    bn(f"latent_space.{n + 1}", latent_dim)
    shapes["classifier.weight"] = (num_classes, latent_dim)
    shapes["classifier.bias"] = (num_classes,)
    return shapes


@contextlib.contextmanager
def exact_f32():
    """float32 products and convolutions without TF32 inside the block."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def normalize(images: torch.Tensor) -> torch.Tensor:
    """Raw [0, 1] (B, H, W, 3) → ImageNet-normalised, float32."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=images.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=images.device)
    return (images.float() - mean) / std


class PeraNetReference:
    """The eval-mode forward of one PeraNet from its state dict."""

    def __init__(self, state: Dict[str, torch.Tensor], backbone: str = "resnet18",
                 layer_outputs: Sequence[str] = ("layer2", "layer3"),
                 latent_space_layers: int = 5, precision: Precision = Precision()):
        self.sd = {k: v.float() for k, v in state.items() if v.is_floating_point()}
        self.block, self.stages, self.width = ARCHS[backbone]
        self.taps = tuple(sorted(layer_outputs))
        self.latent_layers = latent_space_layers
        self.p = precision

    # -- pieces -----------------------------------------------------------------

    def _conv(self, x, key: str, stride: int, pad: int):
        w = self.sd[key + ".weight"]
        return F.conv2d(self.p.operand(x), self.p.operand(w), stride=stride, padding=pad)

    def _bn(self, x, key: str):
        shape = (1, -1) + (1,) * (x.ndim - 2)
        scale = self.sd[key + ".weight"] / torch.sqrt(self.sd[key + ".running_var"] + BN_EPS)
        return ((x - self.sd[key + ".running_mean"].view(shape)) * scale.view(shape)
                + self.sd[key + ".bias"].view(shape))

    def _dense(self, x, key: str):
        y = self.p.operand(x) @ self.p.operand(self.sd[key + ".weight"]).T
        bias = self.sd.get(key + ".bias")
        return y if bias is None else y + bias

    def _block(self, x, key: str, stride: int):
        if self.block == "basic":
            y = F.relu(self._bn(self._conv(x, key + ".conv1", stride, 1), key + ".bn1"))
            y = self._bn(self._conv(y, key + ".conv2", 1, 1), key + ".bn2")
        else:
            y = F.relu(self._bn(self._conv(x, key + ".conv1", 1, 0), key + ".bn1"))
            y = F.relu(self._bn(self._conv(y, key + ".conv2", stride, 1), key + ".bn2"))
            y = self._bn(self._conv(y, key + ".conv3", 1, 0), key + ".bn3")
        if key + ".downsample.0.weight" in self.sd:
            x = self._bn(self._conv(x, key + ".downsample.0", stride, 0), key + ".downsample.1")
        return F.relu(y + x)

    # -- forward ----------------------------------------------------------------

    def trunk(self, x: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """NCHW float32 → (pooled layer4, {'layer1'..'layer4'})."""
        fe = "feature_extractor"
        x = F.relu(self._bn(self._conv(x, fe + ".conv1", 2, 3), fe + ".bn1"))
        x = F.max_pool2d(x, 3, 2, 1)
        feats = {}
        for stage, blocks in enumerate(self.stages, start=1):
            for b in range(blocks):
                x = self._block(x, f"{fe}.layer{stage}.{b}", 2 if stage > 1 and b == 0 else 1)
            feats[f"layer{stage}"] = x
        return x.mean(dim=(2, 3)), feats

    def forward(self, x_normalized: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, H, W, 3) normalised images → (logits (B, C), embeddings (B, D))."""
        x = x_normalized.float().permute(0, 3, 1, 2)
        if x.shape[2] < 64 or x.shape[3] < 64:
            x = F.interpolate(x, size=(max(64, x.shape[2]), max(64, x.shape[3])),
                              mode="nearest")
        with exact_f32():
            pooled, feats = self.trunk(x)
            h = torch.cat([feats[t].mean(dim=(2, 3)) for t in self.taps] + [pooled], dim=1)
            h = self._bn(self._dense(h, "concatenator.0"), "concatenator.1")
            for i in range(self.latent_layers - 2):
                h = F.relu(self._bn(self._dense(h, f"latent_space.{i}.0"),
                                    f"latent_space.{i}.1"))
            n = self.latent_layers - 2
            emb = self._bn(self._dense(h, f"latent_space.{n}"), f"latent_space.{n + 1}")
            logits = self._dense(emb, "classifier")
        return logits, emb
