"""MVTec-AD taxonomy, normalization constants and the output containers.

A copy of ssad_tpu/constants.py (the reference's
src/self_supervised/constants.py:30-119): the plain data, ``METRICS``,
``ModelOutputs`` (its fields hold torch tensors on one device, or numpy
arrays after ``to_host``) and ``EvaluationScores``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

TEXTURES = ("carpet", "grid", "leather", "tile", "wood")

OBJECTS = (
    "bottle",
    "cable",
    "capsule",
    "hazelnut",
    "metal_nut",
    "pill",
    "screw",
    "toothbrush",
    "transistor",
    "zipper",
)

#: Objects whose pose varies image-to-image (per-image object masks).
NON_FIXED_OBJECTS = ("hazelnut", "screw", "metal_nut")

ALL_CATEGORIES = tuple(sorted(TEXTURES + OBJECTS))

#: Evaluation metric names (reference tools.py:28-137).
METRICS = ("auroc", "f1-score", "aupro", "iou")

#: Pretext-task class names in label order.
PRETEXT_CLASSES = ("good", "polygon_patch", "scar", "line")
NUM_PRETEXT_CLASSES = len(PRETEXT_CLASSES)

#: ImageNet normalization constants (reference datasets.py:430-433).
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def is_texture(subject: str) -> bool:
    return subject in TEXTURES


def is_non_fixed_object(subject: str) -> bool:
    return subject in NON_FIXED_OBJECTS


# --- Output containers ------------------------------------------------------


@dataclasses.dataclass
class ModelOutputs:
    """Batched prediction outputs (reference ModelOutputsContainer): every
    field optional, all with one leading batch axis."""

    original_data: Optional[torch.Tensor] = None  # (B,H,W,3) un-normalized
    tensor_data: Optional[torch.Tensor] = None  # (B,H,W,3) normalized input
    y_true_binary: Optional[torch.Tensor] = None  # (B,) {0,1}
    raw_predictions: Optional[torch.Tensor] = None  # (B,num_classes) logits
    y_hat: Optional[torch.Tensor] = None  # (B,) argmax class
    y_true_multiclass: Optional[torch.Tensor] = None  # (B,) pretext labels
    ground_truths: Optional[torch.Tensor] = None  # (B,H,W) binary masks
    anomaly_maps: Optional[torch.Tensor] = None  # (B,) or (B,1,s,s)
    embeddings: Optional[torch.Tensor] = None  # (B,512)

    @staticmethod
    def concat(chunks: list["ModelOutputs"]) -> "ModelOutputs":
        """Concatenate per-batch outputs along the batch axis (reference
        from_list, constants.py:30-53).  A field set in some chunks and
        None in others raises: it would end up shorter than its siblings."""
        out = ModelOutputs()
        for f in dataclasses.fields(ModelOutputs):
            vals = [getattr(c, f.name) for c in chunks]
            present = [v for v in vals if v is not None]
            if present and len(present) != len(vals):
                raise ValueError(
                    f"ModelOutputs.concat: field {f.name!r} is set in "
                    f"{len(present)}/{len(vals)} chunks — concatenating "
                    "would misalign it against fully-populated fields"
                )
            if present:
                setattr(out, f.name, torch.cat([torch.as_tensor(v) for v in present]))
        return out

    def to_host(self) -> "ModelOutputs":
        """A copy with every field as a numpy array."""
        out = ModelOutputs()
        for f in dataclasses.fields(ModelOutputs):
            v = getattr(self, f.name)
            if v is not None:
                setattr(out, f.name, v.detach().cpu().numpy() if torch.is_tensor(v)
                        else np.asarray(v))
        return out


@dataclasses.dataclass
class EvaluationScores:
    """Scalar evaluation results (reference EvaluationOutputContainer)."""

    auroc: Optional[float] = None
    f1_score: Optional[float] = None
    aupro: Optional[float] = None
    iou: Optional[float] = None

    def to_string(self) -> str:
        fmt = lambda v: round(v, 2) if v is not None else None
        return (
            "scores: [\n"
            f"    auroc: {fmt(self.auroc)},\n"
            f"    f1-score: {fmt(self.f1_score)},\n"
            f"    aupro: {fmt(self.aupro)},\n"
            f"    iou: {fmt(self.iou)}\n"
            "]"
        )
