"""Qualitative localization: per-image anomaly-map panels.

Counterpart of ssad_tpu/evaluation/localizer.py:33-130 (reference
src/localizer.py:55-208): for sampled test images, original / heatmap /
anomaly map / ground truth / predicted mask / segmentation panels.

* image level: the Grad-CAM of the predicted class, a zero map where the
  model predicts 'good' (models/gradcam.py);
* patch level: sliding-window scores of a detector fitted on a few
  training images' windows (``setup``) → blur(3) → bilinear resize to
  the image → clamp to [0, 1].  On the card the windows take the fused
  stem kernel (csrc/stem_pool.cu) and the scores the k-NN kernel for the
  bank's size: 3 images give 2,523 windows at 256², 1,766 bank rows after
  the 70/30 split, so csrc/knn_tiled.cu;
* ``localize_single_image`` is the one-shot form.

The detector's 70/30 split is permuted by a CPU ``torch.Generator``
seeded with ``seed`` (the JAX package uses ``jax.random``), unless
``perm`` is given; the sampled test images come from
``np.random.default_rng(seed)``, as in the JAX package, so both write the
same panel files.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from ssad_tpu_torch.config import EvalConfig
from ssad_tpu_torch.data import mvtec
from ssad_tpu_torch.evaluation import inference as inf
from ssad_tpu_torch.models.detector import AnomalyDetector
from ssad_tpu_torch.ops import image as im
from ssad_tpu_torch.utils import convert

#: image mode's mask threshold (reference converters.py:33 heatmap2mask)
IMAGE_THRESHOLD = 0.7


@dataclasses.dataclass
class Localizer:
    engine: inf.InferenceEngine
    cfg: EvalConfig
    detector: Optional[AnomalyDetector] = None

    def setup(self, data: mvtec.PretextData, n_train_images: int = 3, seed: int = 0,
              perm: Optional[torch.Tensor] = None) -> "Localizer":
        """Patch mode: fit the detector on the windows of ``n_train_images``
        training images (a seeded sample), two images per forward."""
        if self.cfg.patch_localization:
            normality = inf.normality_embeddings(
                self.engine, None, data.train_images, batch_size=2, patch_localization=True,
                patch_dim=self.cfg.patch_dim, stride=self.cfg.stride, min_bank_rows=10**9,
                max_images=n_train_images, seed=seed)
            self.detector = AnomalyDetector(k=self.cfg.knn_k).fit(
                normality, torch.Generator().manual_seed(seed), perm=perm)
        return self

    def default_threshold(self) -> float:
        """The detector's calibrated threshold in patch mode, else 0.7."""
        if self.cfg.patch_localization and self.detector is not None:
            return float(self.detector.threshold)
        return IMAGE_THRESHOLD

    def anomaly_map(self, image_raw: np.ndarray) -> np.ndarray:
        """(H, W) anomaly map in [0, 1] of one raw [0,1] (H, W, 3) image."""
        from ssad_tpu_torch.models.gradcam import gradcam_or_zero

        h, w = image_raw.shape[:2]
        x = torch.as_tensor(np.asarray(image_raw, np.float32)).to(self.engine.device)
        x = im.normalize_imagenet(x)[None]
        if self.cfg.patch_localization:
            if self.detector is None:
                raise RuntimeError("call setup() first")
            smap = self.engine.score_maps(x, self.detector.score, dim=self.cfg.patch_dim,
                                          stride=self.cfg.stride)
            smap = im.gaussian_blur(smap[..., None], ksize=3)[..., 0]
            smap = im.resize_bilinear(smap[0], (h, w))
            return smap.clamp(0.0, 1.0).cpu().numpy()
        logits, _ = self.engine.predict_batch(x)
        maps = gradcam_or_zero(self.engine.model, x, convert.prediction_class(logits))
        return maps[0].cpu().numpy()

    def localize(self, test_data: mvtec.MVTecTestData, outputs_dir: str, num_images: int = 5,
                 seed: int = 0, threshold: Optional[float] = None) -> List[str]:
        """Panels of ``num_images`` sampled test images under
        ``outputs_dir`` as ``<subject>_<defect>_<stem>_panel.png``
        (reference localizer.py:125-186) → their paths."""
        from ssad_tpu_torch.evaluation import visualization as vis

        rng = np.random.default_rng(seed)
        n = test_data.images.shape[0]
        picks = rng.choice(n, size=min(num_images, n), replace=False)
        if threshold is None:
            threshold = self.default_threshold()
        paths = []
        for i in picks:
            image = test_data.images[i]
            amap = self.anomaly_map(image)
            name = Path(test_data.filenames[i]).stem
            defect = Path(test_data.filenames[i]).parent.name
            paths.append(vis.localization_panel(
                image, amap, test_data.ground_truths[i], amap > threshold, outputs_dir,
                f"{test_data.subject}_{defect}_{name}_panel.png"))
        return paths

    def localize_single_image(self, image_raw: np.ndarray, threshold: Optional[float] = None):
        """(anomaly map, predicted mask) of one image (reference
        localizer.py:189-208)."""
        amap = self.anomaly_map(np.asarray(image_raw))
        return amap, amap > (self.default_threshold() if threshold is None else threshold)
