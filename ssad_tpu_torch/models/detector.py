"""AnomalyDetector: k-NN cosine scoring against a normal-embedding bank.

Counterpart of ssad_tpu/models/detector.py:24-117 (the k-NN detector;
the Mahalanobis one is slice 7 of the port).  fit() splits the
normality embeddings 70/30, keeps the 70% as the bank and calibrates the
threshold on the 30%: the max validation score (the reference's rule,
models.py:352-361) or its .99 quantile.  Scoring goes through
ops/knn.py, so on a CUDA tensor both the fit and predict launch the
k-NN kernel for the bank's size (csrc/knn.cu up to 1024 rows,
csrc/knn_tiled.cu above).

The JAX split permutation comes from ``jax.random``; here it comes from
a ``torch.Generator`` — or from an explicit ``perm``, which is how the
tests hand both packages the same split.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ssad_tpu_torch.ops.knn import knn_cosine_scores


@dataclasses.dataclass
class AnomalyDetector:
    """k-NN cosine anomaly scorer.  In patch mode ``predict`` reshapes the
    ``batch`` · ``num_patches`` scores to (batch, 1, side, side) maps
    (models.py:363-370)."""

    k: int = 3
    #: 'max' (the reference rule) or 'quantile' (.99 quantile)
    threshold_rule: str = "max"
    patch_level: bool = False
    batch: Optional[int] = None
    num_patches: Optional[int] = None

    bank: Optional[torch.Tensor] = None  # (M, D) fitted normality bank
    threshold: Optional[float] = None
    #: validation-split scores kept by fit(): the calibration
    #: distribution serving drift monitoring compares against
    calibration_scores: Optional[torch.Tensor] = None

    def fit(
        self,
        embeddings: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        perm: Optional[torch.Tensor] = None,
    ) -> "AnomalyDetector":
        """70/30 split of ``embeddings`` (on its device), threshold from
        the validation part.  ``perm`` overrides the generator's
        permutation."""
        emb = torch.as_tensor(embeddings)
        m = emb.shape[0]
        if m < self.k + 1:
            raise ValueError(
                f"need at least k+1={self.k + 1} normality embeddings, got {m}"
            )
        if perm is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            perm = torch.randperm(m, generator=generator)
        perm = torch.as_tensor(perm, dtype=torch.long, device=emb.device)
        if perm.shape != (m,):
            raise ValueError(f"perm must have shape ({m},), got {tuple(perm.shape)}")
        n_val = max(int(round(m * 0.3)), 1)
        n_train = m - n_val
        if n_train < self.k:
            n_train, n_val = self.k, m - self.k
        self.bank = emb[perm[n_val:]]
        val = emb[perm[:n_val]]
        val_scores = knn_cosine_scores(val, self.bank, k=self.k)
        self.calibration_scores = val_scores
        if self.threshold_rule == "quantile":
            self.threshold = float(torch.quantile(val_scores, 0.99))
        elif self.threshold_rule == "max":
            self.threshold = float(torch.max(val_scores))
        else:
            raise ValueError(
                f"threshold_rule must be 'max' or 'quantile', got {self.threshold_rule!r}"
            )
        return self

    def predict(self, queries: torch.Tensor) -> torch.Tensor:
        """Mean cosine distance to the k nearest bank rows; patch mode
        reshapes them to (batch, 1, side, side) maps."""
        if self.bank is None:
            raise RuntimeError("fit() before predict()")
        scores = knn_cosine_scores(torch.as_tensor(queries), self.bank, k=self.k)
        if self.patch_level:
            if not self.batch or not self.num_patches:
                raise ValueError("patch mode needs batch and num_patches")
            side = int(self.num_patches ** 0.5)
            scores = scores.reshape(self.batch, 1, side, side)
        return scores

    def predict_labels(self, queries: torch.Tensor) -> torch.Tensor:
        """Binary anomaly decision by the calibrated threshold."""
        return (self.predict(queries) > self.threshold).to(torch.int32)
