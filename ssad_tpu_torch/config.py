"""Dataclass configuration: ssad_tpu/config.py's AugConfig, DataConfig,
ModelConfig, OptimConfig, MeshConfig, TrainConfig with its JSON form, and
EvalConfig.

Defaults are the JAX package's, which reproduce the reference's values
(file:line citations into the reference's src/).  A ``train_config.json``
written by either package reads in the other (``TrainConfig.to_json`` /
``from_json``: the same field names, order and nesting).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple


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
    """Dataset discovery and batching (reference datasets.py:401-433).  The
    defaults of ``data.mvtec.prepare_pretext_data`` / ``load_split``,
    ``data.synthetic.SynthSpec`` and ``cli qa`` are read from here."""

    dataset_dir: str = "dataset"
    subject: str = "bottle"
    imsize: Tuple[int, int] = (256, 256)
    batch_size: int = 96  # tools.py:212 default
    train_val_split: float = 0.2  # datasets.py:408
    seed: int = 0
    min_dataset_length: int = 1000  # datasets.py:410
    duplication: bool = True
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
    #: rows of a batch considered for the memory-bank fill per step; None
    #: embeds every accepted y==0 ∧ ŷ==0 row, the reference behaviour
    #: (models.py:270-275)
    bank_fill_rows: Optional[int] = None
    #: dtype of the backbone's convolutions and BatchNorms; the head runs
    #: in float32 either way
    compute_dtype: str = "bfloat16"
    #: the JAX package's space-to-depth stem (a TPU layout of the same
    #: 7×7/s2 conv); carried so that a train_config.json round-trips, and
    #: ignored: the port runs the 7×7/s2 conv either way
    stem_s2d: bool = False
    #: a torchvision resnet18 state dict (.pth) to start the backbone from;
    #: None starts from the Lecun-normal init (the reference always starts
    #: from ImageNet weights, models.py:59)
    pretrained_backbone: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    """Two-phase schedule (reference tools.py:213-214, models.py:336-341)."""

    projection_epochs: int = 10
    projection_lr: float = 0.03
    fine_tune_epochs: int = 30
    fine_tune_lr: float = 0.005
    momentum: float = 0.9
    weight_decay: float = 5e-4
    #: best-val-loss copy cadence in fine-tune (tools.py:290)
    checkpoint_every_n_epochs: int = 5
    #: validation batches per epoch; None = the full pass (tools.py:284-306)
    val_batches: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """The JAX package's device-mesh layout.  The port trains on one device
    and only carries this, so that a ``train_config.json`` round-trips."""

    data_axis: int = -1
    model_axis: int = 1


_SECTIONS = {"data": DataConfig, "aug": AugConfig, "model": ModelConfig,
             "optim": OptimConfig, "mesh": MeshConfig}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    aug: AugConfig = dataclasses.field(default_factory=AugConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    outputs_dir: str = "outputs"
    seed: int = 0

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(s: str) -> "TrainConfig":
        """Unknown keys are ignored and missing ones take their defaults;
        JSON lists become tuples."""

        def build(cls, d):
            kw = {}
            for f in dataclasses.fields(cls):
                if f.name not in d:
                    continue
                v = d[f.name]
                kw[f.name] = build(_SECTIONS[f.name], v) if f.name in _SECTIONS else _to_tuple(v)
            return cls(**kw)

        return build(TrainConfig, json.loads(s))


def _to_tuple(v):
    if isinstance(v, list):
        return tuple(_to_tuple(x) for x in v)
    return v


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """Evaluation sweep options (reference evaluator.py:432-444), the JAX
    package's fields and defaults.  The Mahalanobis scorer and the coreset
    are slice 7 of the port, data and category sharding slice 9: asking
    for them raises ``NotImplementedError``."""

    metrics: Tuple[str, ...] = ("auroc", "f1-score")
    patch_localization: bool = False
    patch_dim: int = 32
    stride: int = 8
    #: anomaly-map upsample target; None tracks imsize (the GT masks load
    #: at imsize, and pixel metrics need both on one grid)
    upsample_size: Optional[int] = None
    aupro_fpr_limit: float = 0.3  # evaluator.py / tools.py:118
    knn_k: int = 3  # reference models.py:354
    #: 'knn' (models.py:345-370); 'mahalanobis' is not ported yet
    scorer: str = "knn"
    #: patch mode: training images re-embedded for normality
    n_normality_images: int = 3
    #: k-center coreset size (not ported yet; None keeps every row)
    coreset: Optional[int] = None
    imsize: Tuple[int, int] = (256, 256)
    batch_size: int = 32
    seed: int = 0
    data_shards: Optional[int] = None
    category_shards: Optional[int] = None
    #: pixel metrics by the fused program of evaluation/metrics_device.py;
    #: None: on when the anomaly maps are on a CUDA device
    device_metrics: Optional[bool] = None

    def __post_init__(self):
        if self.scorer == "mahalanobis":
            raise NotImplementedError(
                "scorer='mahalanobis' is slice 7 of the port (ROADMAP.md); use 'knn'")
        if self.scorer != "knn":
            raise ValueError(f"unknown scorer {self.scorer!r}; valid: knn, mahalanobis")
        if self.coreset is not None:
            raise NotImplementedError("coreset is slice 7 of the port (ROADMAP.md)")
        for name in ("data_shards", "category_shards"):
            if (getattr(self, name) or 1) > 1:
                raise NotImplementedError(
                    f"{name} > 1 (multi-device evaluation) is slice 9 of the port (ROADMAP.md)")
        if self.upsample_size is None:
            object.__setattr__(self, "upsample_size", self.imsize[0])
