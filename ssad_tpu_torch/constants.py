"""MVTec-AD taxonomy and normalization constants.

A copy of the plain-data part of ssad_tpu/constants.py (the reference's
src/self_supervised/constants.py:84-119).  The output container
``ModelOutputs`` waits for the evaluation slice.
"""

from __future__ import annotations

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
