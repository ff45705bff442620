"""Dataclass configuration: the parts of ssad_tpu/config.py this slice
reads (DataConfig.imsize, ModelConfig, EvalConfig.knn_k).

Defaults are the JAX package's, which reproduce the reference's values.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Input geometry (reference datasets.py:401-433)."""

    imsize: Tuple[int, int] = (256, 256)


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
