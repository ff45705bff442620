"""A torchvision ResNet state dict (ImageNet weights) loaded into the
PeraNet backbone: resnet18, resnet34, resnet50 or wide_resnet50_2.

Counterpart of ssad_tpu/utils/torch_weights.py:28-99.  The port's
``feature_extractor`` has torchvision's module names, so the conversion
keeps each tensor as it is: ``convert_resnet_state_dict`` drops ``fc.*``
and ``num_batches_tracked``, tells basic blocks (conv1-2) from bottleneck
ones (conv1-3) and reads the stage depths off the key set, as the JAX
converter does.  The BatchNorm running statistics load with the weights
(the reference loads the full state dict, models.py:59; eval-mode
embeddings are wrong without them).  Keys and shapes are checked against
the model's backbone; a mismatch raises.  Nothing is downloaded: the user
supplies the file (``ModelConfig.pretrained_backbone``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Mapping

import torch

from ssad_tpu_torch.models.peranet import PeraNet


def convert_resnet_state_dict(state_dict: Mapping) -> Dict[str, torch.Tensor]:
    """A torchvision ResNet-family state dict → the backbone's entries,
    stem and ``layer{s}.{b}`` blocks for as many stages and blocks as the
    keys hold (conv1-2 per basic block, conv1-3 per bottleneck block, the
    projection shortcut where present).  A missing entry raises KeyError."""
    sd = {k: torch.as_tensor(v) for k, v in state_dict.items()}
    out: Dict[str, torch.Tensor] = {"conv1.weight": sd["conv1.weight"]}

    def bn(prefix: str):
        for name in ("weight", "bias", "running_mean", "running_var"):
            out[f"{prefix}.{name}"] = sd[f"{prefix}.{name}"]

    bn("bn1")
    for stage in range(1, 5):
        block = 0
        while f"layer{stage}.{block}.conv1.weight" in sd:
            prefix = f"layer{stage}.{block}"
            n_convs = 3 if f"{prefix}.conv3.weight" in sd else 2
            for c in range(1, n_convs + 1):
                out[f"{prefix}.conv{c}.weight"] = sd[f"{prefix}.conv{c}.weight"]
                bn(f"{prefix}.bn{c}")
            if f"{prefix}.downsample.0.weight" in sd:
                out[f"{prefix}.downsample.0.weight"] = sd[f"{prefix}.downsample.0.weight"]
                bn(f"{prefix}.downsample.1")
            block += 1
    return out


def load_resnet18_into(model: PeraNet, path: str | Path) -> PeraNet:
    """Replace ``model.feature_extractor``'s parameters and running
    statistics with those of the torchvision-layout file at ``path`` (any
    of the four architectures; the JAX package's name for the loader)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    target = model.feature_extractor.state_dict()
    try:
        converted = convert_resnet_state_dict(sd)
    except KeyError as e:
        raise ValueError(f"{path}: not a torchvision ResNet state dict (no {e})") from None
    # torchvision files carry num_batches_tracked; older ones may not
    optional = {k for k in target if k.endswith("num_batches_tracked")}
    missing = sorted(set(target) - set(converted) - optional)
    unexpected = sorted(set(converted) - set(target))
    if missing or unexpected:
        raise ValueError(f"{path}: not a torchvision state dict of this backbone "
                         f"(missing {missing[:5]}, unexpected {unexpected[:5]})")
    for k, v in converted.items():
        if tuple(v.shape) != tuple(target[k].shape):
            raise ValueError(f"{path}: {k} has shape {tuple(v.shape)}, "
                             f"expected {tuple(target[k].shape)}")
        target[k] = v.to(target[k].dtype)
    model.feature_extractor.load_state_dict(target, strict=True)
    return model
