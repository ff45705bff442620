"""PeraNet: ResNet (or DINOv2 transformer) backbone + concat head + latent
MLP + classifier.

Counterpart of ssad_tpu/models/peranet.py:37-132, with the reference's
state-dict layout (models.py:58-99), so a reference Lightning
``best_model.ckpt`` loads with ``strict=True``:

  feature_extractor.*          torchvision resnet18/34/50, wide_resnet50_2 (no fc),
                               or DINOv2's dinov2_vitg14_reg (models/vit.py)
  concatenator.{0,1}           Linear(taps + pooled → 512, no bias) + BN:
                               896 → 512 for ResNet-18/34 (128 + 256 + 512),
                               3,584 → 512 for the bottleneck family
                               (512 + 1024 + 2048), 4,608 → 512 for
                               ViT-g/14 (3 × 1536: two taps and the CLS token)
  latent_space.{i}.{0,1}       3 × [Linear(512, no bias) + BN + ReLU]
  latent_space.{3,4}           Linear(512, bias) + BN   → embedding
  classifier                   Linear(512 → num_classes)

Images enter as (B, H, W, 3) float32 — the JAX package's public layout —
and are moved to NCHW here.  Inputs under 64 px are nearest-upsampled to
64 first (models.py:218-219), except exactly 32×32 ones, which take the
folded 4×4 stem: the same function without the 4× upsampled image
(ssad_tpu/models/peranet.py:73-87).  ``from_stem`` re-enters after the
stem's maxpool, for the fused stem kernel (ops/stem_pool.py).  The
backbone runs in ``compute_dtype``; the taps are averaged in f32 and the
head runs in f32.  ``train()``/``eval()`` select batch or running
statistics in every BatchNorm (models/resnet.py).  ``ModelConfig.stem_s2d``
is read and ignored: the JAX package's space-to-depth stem computes the
7×7/s2 conv's function, which the port runs as that conv.

The transformer trunk takes none of the CNN rules above: no 64-px
upsampling and no folded stem; its images' sides are multiples of 14.
It serves image mode only: patch mode (the fused stem), Grad-CAM and
training need a convolutional trunk and refuse it (``require_cnn``).

``init_model`` draws the JAX package's initial distribution
(ssad_tpu/models/peranet.py:135-140, Flax defaults), not PyTorch's, and
DINOv2's for the transformer's tables, LayerNorms and LayerScales.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

from ssad_tpu_torch.config import ModelConfig
from ssad_tpu_torch.models import resnet, vit
from ssad_tpu_torch.models.resnet import BatchNorm1d, FlaxBatchNorm, lecun_normal_
from ssad_tpu_torch.models.vit import VisionTransformer, init_vit_
from ssad_tpu_torch.ops.image import resize_nearest

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def make_backbone(arch: str, dtype: torch.dtype = torch.float32) -> nn.Module:
    """The trunk ``arch`` in ``dtype``: a ResNet (``resnet.BACKBONES``) or a
    transformer (``vit.BACKBONES``, image mode only)."""
    if arch in vit.BACKBONES:
        return vit.BACKBONES[arch](dtype)
    if arch not in resnet.BACKBONES:
        raise ValueError(f"unknown backbone '{arch}' (resnet18 | resnet34 | resnet50 | "
                         "wide_resnet50_2 | dinov2_vitg14_reg)")
    return resnet.make_backbone(arch, dtype)


class PeraNet(nn.Module):
    """forward returns {'classifier': (B, num_classes), 'latent_space':
    (B, latent_dim)}, both f32, like the reference forward."""

    def __init__(
        self,
        num_classes: int = 4,
        backbone_arch: str = "resnet18",
        layer_outputs: Sequence[str] = ("layer2", "layer3"),
        latent_space_layers: int = 5,
        latent_dim: int = 512,
        compute_dtype: torch.dtype = torch.bfloat16,
    ):
        super().__init__()
        self.num_classes = num_classes
        self.backbone_arch = backbone_arch
        # the reference concatenates taps in ascending layer order
        self.layer_outputs = tuple(sorted(layer_outputs))
        self.compute_dtype = compute_dtype
        self.feature_extractor = make_backbone(backbone_arch, dtype=compute_dtype)
        widths = self.feature_extractor.stage_channels
        in_dim = sum(widths[t] for t in self.layer_outputs) + widths["layer4"]
        self.concatenator = nn.Sequential(
            nn.Linear(in_dim, latent_dim, bias=False), BatchNorm1d(latent_dim)
        )
        blocks = [
            nn.Sequential(
                nn.Linear(latent_dim, latent_dim, bias=False),
                BatchNorm1d(latent_dim),
                nn.ReLU(),
            )
            for _ in range(max(latent_space_layers - 2, 0))
        ]
        self.latent_space = nn.Sequential(
            *blocks, nn.Linear(latent_dim, latent_dim, bias=True), BatchNorm1d(latent_dim)
        )
        self.classifier = nn.Linear(latent_dim, num_classes)

    def backbone_features(self, x: torch.Tensor):
        """(B, H, W, 3) → (pooled (B, C4), {'layer1'..'layer4': NCHW})."""
        if self.is_transformer:
            return self.feature_extractor(x.permute(0, 3, 1, 2))
        if x.shape[1] == 32 and x.shape[2] == 32:
            return self.feature_extractor(x.permute(0, 3, 1, 2), stem_fold_2x=True)
        if x.shape[1] < 64 or x.shape[2] < 64:
            # resize_nearest works on leading (H, W) axes: (B,H,W,C) → (H,W,B,C)
            x = resize_nearest(x.permute(1, 2, 0, 3), (64, 64)).permute(2, 0, 1, 3)
        return self.feature_extractor(x.permute(0, 3, 1, 2))

    @property
    def is_transformer(self) -> bool:
        return isinstance(self.feature_extractor, VisionTransformer)

    def from_stem(self, x_stem: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Forward from a post-maxpool stem output (B, h, w, 64), channels
        last as the fused stem writes it; the NCHW view is not copied."""
        pooled, feats = self.feature_extractor.forward_stages(x_stem.permute(0, 3, 1, 2))
        return self.head(feats, pooled)

    def head(self, feats: Dict[str, torch.Tensor], pooled: torch.Tensor):
        """Tap means + pooled features → concat head → latent MLP →
        classifier."""
        parts = [feats[tap].float().mean(dim=(2, 3)) for tap in self.layer_outputs]
        features = torch.cat(parts + [pooled], dim=1)  # [f2, f3, f4]
        embedding = self.latent_space(self.concatenator(features))
        return {"classifier": self.classifier(embedding), "latent_space": embedding}

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        pooled, feats = self.backbone_features(x)
        return self.head(feats, pooled)


def require_cnn(model: PeraNet, what: str) -> None:
    """ValueError naming the trunk when ``what`` needs a convolutional one."""
    if model.is_transformer:
        raise ValueError(f"{what} needs a convolutional trunk; {model.backbone_arch!r} is a "
                         "transformer, served in image mode only")


def build_model(cfg: ModelConfig) -> PeraNet:
    if cfg.compute_dtype not in DTYPES:
        raise ValueError(f"compute_dtype must be one of {sorted(DTYPES)}")
    return PeraNet(
        num_classes=cfg.num_classes,
        backbone_arch=cfg.backbone,
        layer_outputs=tuple(cfg.layer_outputs),
        latent_space_layers=cfg.latent_space_layers,
        latent_dim=cfg.latent_dim,
        compute_dtype=DTYPES[cfg.compute_dtype],
    )


def init_model(model: PeraNet, generator: torch.Generator) -> PeraNet:
    """Re-initialise ``model`` in place as the JAX ``init_model`` does:
    Lecun-normal (truncated) conv and dense weights, zero dense biases,
    BatchNorm scale 1, bias 0, running mean 0 and running variance 1; a
    transformer trunk's tables, LayerNorms and LayerScales as DINOv2
    (``vit.init_vit_``).  PyTorch's own init (Kaiming-uniform, a = √5) is
    another distribution.
    ``generator``: a CPU ``torch.Generator``; call before moving the model
    to a device, so every device starts from the same values."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            lecun_normal_(m.weight, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, FlaxBatchNorm):
            m.reset_parameters()
    if model.is_transformer:
        init_vit_(model.feature_extractor, generator)
    return model
