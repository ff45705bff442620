"""A torchvision ResNet-18 state dict (ImageNet weights) loaded into the
PeraNet backbone.

Counterpart of ssad_tpu/utils/torch_weights.py:76-99.  The port's
``feature_extractor`` has torchvision's module names, so the file's keys
load as they are: ``fc.*`` is dropped, and the BatchNorm running
statistics load with the weights (the reference loads the full state
dict, models.py:59; eval-mode embeddings are wrong without them).  Keys
and shapes are checked; a mismatch raises.  Nothing is downloaded: the
user supplies the file (``ModelConfig.pretrained_backbone``).
"""

from __future__ import annotations

from pathlib import Path

import torch

from ssad_tpu_torch.models.peranet import PeraNet


def load_resnet18_into(model: PeraNet, path: str | Path) -> PeraNet:
    """Replace ``model.feature_extractor``'s parameters and running
    statistics with those of the torchvision-layout file at ``path``."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    sd = {k: v for k, v in sd.items() if not k.startswith("fc.")}
    target = model.feature_extractor.state_dict()
    # torchvision files carry num_batches_tracked; older ones may not
    optional = {k for k in target if k.endswith("num_batches_tracked")}
    missing = sorted(set(target) - set(sd) - optional)
    unexpected = sorted(set(sd) - set(target))
    if missing or unexpected:
        raise ValueError(f"{path}: not a torchvision resnet18 state dict "
                         f"(missing {missing[:5]}, unexpected {unexpected[:5]})")
    for k, v in sd.items():
        if tuple(v.shape) != tuple(target[k].shape):
            raise ValueError(f"{path}: {k} has shape {tuple(v.shape)}, "
                             f"expected {tuple(target[k].shape)}")
        target[k] = v.to(target[k].dtype)
    model.feature_extractor.load_state_dict(target, strict=True)
    return model
