"""Dataclass configuration: the parts of ssad_tpu/config.py the ported
slices read (AugConfig; DataConfig without the training-loop fields;
ModelConfig; EvalConfig.knn_k).

Defaults are the JAX package's, which reproduce the reference's values
(file:line citations into the reference's src/).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class AugConfig:
    """Synthetic-defect ("CutPaste++") hyperparameters: the reference's CPP
    namespace (datasets.py:33-47) and the values hard-coded in
    PretextTaskDataset.__getitem__."""

    jitter_offset: float = 0.1  # ColorJitter b/c/s (datasets.py:34)

    # polygon-patch defect (label 1)
    patch_area_ratio: Tuple[float, float] = (0.03, 0.07)  # image-wise (datasets.py:37)
    patch_area_ratio_patchmode: Tuple[float, float] = (0.2, 0.5)  # patch-wise (datasets.py:36)
    patch_aspect_ratio: Tuple[Tuple[float, float], Tuple[float, float]] = (
        (0.3, 0.5),
        (1.0, 3.3),
    )  # datasets.py:38

    # scar defect (label 2)
    scar_area_ratio: Tuple[float, float] = (0.003, 0.007)  # datasets.py:41
    scar_area_ratio_patchmode: Tuple[float, float] = (0.02, 0.05)  # datasets.py:40
    scar_aspect_ratio: Tuple[Tuple[float, float], Tuple[float, float]] = (
        (0.3, 0.5),
        (2.5, 3.3),
    )  # datasets.py:42
    scar_angle_range: Tuple[int, int] = (-45, 45)  # datasets.py:342
    scar_copies: Tuple[int, int] = (2, 5)  # datasets.py:341

    # line defect (label 3)
    line_points_image: int = 60  # datasets.py:360
    line_points_patch: int = 30  # datasets.py:360
    line_width_image: int = 3  # datasets.py:388
    line_width_patch: int = 1  # datasets.py:385
    line_splits: int = 10  # datasets.py:375

    # paste containers (datasets.py:238-239; 1.0 in patch mode :255-256)
    container_scale_patch: float = 1.75
    container_scale_scar: float = 2.0

    # colorization mix for patch/scar crops: crop / average / random color
    # (datasets.py:270, :311)
    color_probs: Tuple[float, float, float] = (0.7, 0.15, 0.15)
    #: brightness retouch when the defect's colour is close to the
    #: image's (datasets.py:295-299)
    similarity_threshold: float = 0.99
    brightness_low: Tuple[float, float] = (0.75, 0.9)
    brightness_high: Tuple[float, float] = (1.1, 1.15)

    # random affine of fixed-pose subjects at image level (datasets.py:220-222)
    affine_degrees: float = 3.0
    affine_scale: Tuple[float, float] = (1.05, 1.1)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset geometry and batching (reference datasets.py:401-433).  The
    defaults of ``data.mvtec.prepare_pretext_data`` / ``load_split``,
    ``data.synthetic.SynthSpec`` and ``cli qa`` are read from here."""

    imsize: Tuple[int, int] = (256, 256)
    batch_size: int = 96  # tools.py:212 default
    train_val_split: float = 0.2  # datasets.py:408
    seed: int = 0
    patch_localization: bool = False
    patch_size: int = 64  # training crop in patch mode (datasets.py:174)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """PeraNet architecture (reference models.py:21-146)."""

    backbone: str = "resnet18"
    #: multi-scale feature taps concatenated with the pooled output
    layer_outputs: Tuple[str, ...] = ("layer2", "layer3")
    latent_space_layers: int = 5
    latent_dim: int = 512
    num_classes: int = 4
    memory_bank_size: int = 1000
    #: dtype of the backbone's convolutions and BatchNorms; the head runs
    #: in float32 either way
    compute_dtype: str = "bfloat16"


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """Scoring options this slice reads."""

    knn_k: int = 3  # reference models.py:354
