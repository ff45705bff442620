"""Grad-CAM saliency for image-level localization.

Counterpart of ssad_tpu/models/gradcam.py:25-98 (reference
gradcam.py:7-48): the gradient of the summed target-class logits with
respect to the layer-4 activation, the head re-applied from that
activation (``PeraNet.head``), then

    α_k = spatial-mean ∂score/∂A_k (f32);  saliency = ReLU(Σ_k α_k A_k)
    → bilinear resize to the input size → per-sample min-max.

The model runs in eval mode under ``torch.no_grad()``, all but the head's
re-application, which ``torch.autograd.grad`` differentiates.
"""

from __future__ import annotations

from typing import Optional

import torch

from ssad_tpu_torch.models.peranet import PeraNet
from ssad_tpu_torch.ops.image import resize_bilinear


def compute_gradcam(model: PeraNet, x: torch.Tensor, class_idx: Optional[int] = None
                    ) -> torch.Tensor:
    """Saliency maps (B, H, W) in [0, 1] of a normalized (B, H, W, 3)
    batch on the model's device.  ``class_idx``: the target class, or None
    for each sample's argmax (reference gradcam.py:32-35)."""
    model.eval()
    h, w = x.shape[1], x.shape[2]
    with torch.no_grad():
        pooled, feats = model.backbone_features(x)
        logits0 = model.head(feats, pooled)["classifier"]
        targets = (logits0.argmax(dim=-1) if class_idx is None
                   else torch.full((x.shape[0],), class_idx, device=x.device))
    a4 = feats["layer4"].detach().requires_grad_(True)
    with torch.enable_grad():
        # the pooled features of layer 4, as the JAX Grad-CAM pools them
        # (an f32 mean, no rounding to the compute dtype)
        logits = model.head(dict(feats, layer4=a4), a4.float().mean(dim=(2, 3)))["classifier"]
        score = logits.gather(1, targets[:, None]).sum()
        (grads,) = torch.autograd.grad(score, a4)
    with torch.no_grad():
        alpha = grads.float().mean(dim=(2, 3))  # (B, C)
        sal = torch.relu((a4.float() * alpha[:, :, None, None]).sum(dim=1))  # (B, h4, w4)
        sal = resize_bilinear(sal.permute(1, 2, 0), (h, w)).permute(2, 0, 1)
        # per-sample min-max (the reference runs batch 1)
        lo = sal.amin(dim=(1, 2), keepdim=True)
        hi = sal.amax(dim=(1, 2), keepdim=True)
        return (sal - lo) / torch.clamp(hi - lo, min=1e-12)


def gradcam_or_zero(model: PeraNet, x: torch.Tensor, predicted_classes) -> torch.Tensor:
    """A zero map where the model predicts 'good', the Grad-CAM of the
    predicted defect class elsewhere (reference localizer.py:133-140)."""
    maps = compute_gradcam(model, x)
    good = torch.as_tensor(predicted_classes, device=maps.device) == 0
    return torch.where(good[:, None, None], torch.zeros_like(maps), maps)


def make_gradcam_fn(model: PeraNet):
    """(x, predicted_classes) → maps, the JAX package's closure form."""
    return lambda x, predicted: gradcam_or_zero(model, x, predicted)
