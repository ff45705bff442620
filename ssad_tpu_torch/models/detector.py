"""The anomaly detectors: k-NN cosine scoring against a normal-embedding
bank, and Mahalanobis distance to a Gaussian fitted to the normal
embeddings.

Counterpart of ssad_tpu/models/detector.py.  Both fit() calls split the
normality embeddings 70/30 and calibrate the threshold on the 30%: the
max validation score (the reference's rule, models.py:352-361), or for
k-NN optionally its .99 quantile.

* ``AnomalyDetector`` keeps the 70% as the bank, or with ``coreset`` a
  k-center-greedy coreset of it (ops/coreset.py), selected after the
  split.  Scoring goes through ops/knn.py, so on a CUDA tensor both the
  fit and predict launch the k-NN kernel for the bank's size
  (csrc/knn.cu up to 1024 rows, csrc/knn_tiled.cu above).
* ``MahalanobisDetector`` fits the mean and a precision matrix, the
  covariance shrunk by 0.1 toward trace/D·I and inverted.  It runs no
  kernel of its own: scoring is one (Q, D) × (D, D) product in
  ``mahalanobis_distances``.

Both have one scoring call over flat embeddings, ``score`` (N, D) → (N,),
and ``predict`` (``score`` plus the patch reshape); ``make_detector``
picks one by the scorer's name, so the evaluator, the export and the
served artifact score either without knowing which.

The JAX split permutation comes from ``jax.random``; here it comes from
a ``torch.Generator`` — or from an explicit ``perm``, which is how the
tests hand both packages the same split.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ssad_tpu_torch.ops.coreset import coreset_select
from ssad_tpu_torch.ops.knn import knn_cosine_scores, prepare_bank

#: the scorers ``make_detector`` builds
SCORERS = ("knn", "mahalanobis")


def _split(m: int, generator: Optional[torch.Generator], perm, device) -> torch.Tensor:
    """The 70/30 split's permutation: ``perm`` when given, else drawn from
    ``generator`` (seed 0 when None) on the CPU."""
    if perm is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        perm = torch.randperm(m, generator=generator)
    perm = torch.as_tensor(perm, dtype=torch.long, device=device)
    if perm.shape != (m,):
        raise ValueError(f"perm must have shape ({m},), got {tuple(perm.shape)}")
    return perm


class _Detector:
    """What both detectors share: ``predict`` is ``score`` with the patch
    reshape, ``predict_labels`` the threshold's decision."""

    def predict(self, queries: torch.Tensor) -> torch.Tensor:
        """Scores of the query rows; patch mode reshapes them to (batch,
        1, side, side) maps."""
        scores = self.score(torch.as_tensor(queries))
        if self.patch_level:
            if not self.batch or not self.num_patches:
                raise ValueError("patch mode needs batch and num_patches")
            side = int(self.num_patches ** 0.5)
            scores = scores.reshape(self.batch, 1, side, side)
        return scores

    def predict_labels(self, queries: torch.Tensor) -> torch.Tensor:
        """Binary anomaly decision by the calibrated threshold."""
        return (self.predict(queries) > self.threshold).to(torch.int32)


@dataclasses.dataclass
class AnomalyDetector(_Detector):
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
    #: (bank, its prepare_bank form): made once per bank by scoring_bank()
    _prepared: Optional[tuple] = dataclasses.field(default=None, init=False, repr=False,
                                                   compare=False)

    def fit(
        self,
        embeddings: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        perm: Optional[torch.Tensor] = None,
        coreset: Optional[int] = None,
    ) -> "AnomalyDetector":
        """70/30 split of ``embeddings`` (on its device), threshold from
        the validation part.  ``perm`` overrides the generator's
        permutation.

        ``coreset``: distil the TRAIN part to this many rows by
        k-center-greedy selection and keep the whole coreset as the bank
        (its first center drawn from ``generator`` after the
        permutation).  Selection comes after the split, never
        before: every k-center row is the sole cover of its region of the
        normal manifold, so splitting a selected coreset would delete 30 %
        of the cover, and the threshold would be calibrated on coreset
        rows against a punctured bank instead of on raw held-out rows
        against the bank that scores (the JAX docstring has the measured
        cost)."""
        emb = torch.as_tensor(embeddings)
        m = emb.shape[0]
        if m < self.k + 1:
            raise ValueError(
                f"need at least k+1={self.k + 1} normality embeddings, got {m}"
            )
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        perm = _split(m, generator, perm, emb.device)
        n_val = max(int(round(m * 0.3)), 1)
        n_train = m - n_val
        if n_train < self.k:
            n_train, n_val = self.k, m - self.k
        self.bank = emb[perm[n_val:]]
        if coreset is not None and self.bank.shape[0] > coreset:
            self.bank = coreset_select(self.bank, coreset, generator)
        val = emb[perm[:n_val]]
        val_scores = self.score(val)
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

    def scoring_bank(self):
        """The bank in the form k-NN scoring takes (``ops.knn.prepare_bank``:
        on the card a bank above 1024 rows is normalised and split), made
        once per bank instead of on every call."""
        if self._prepared is None or self._prepared[0] is not self.bank:
            self._prepared = (self.bank, prepare_bank(self.bank))
        return self._prepared[1]

    def score(self, queries: torch.Tensor) -> torch.Tensor:
        """(N, D) → (N,) mean cosine distance to the k nearest bank rows."""
        if self.bank is None:
            raise RuntimeError("fit() before predict()")
        return knn_cosine_scores(queries, self.scoring_bank(), k=self.k)

    def arrays(self) -> dict:
        """What makes the fitted detector again (``make_detector``'s
        ``fields``; an artifact's payload)."""
        return {"bank": self.bank}


def mahalanobis_distances(queries: torch.Tensor, mean: torch.Tensor,
                          precision: torch.Tensor) -> torch.Tensor:
    """sqrt(max((q − μ)ᵀ P (q − μ), 0)) per query row, f32.

    The one Mahalanobis scoring formula: the detector's fit and threshold
    calibration, ``InferenceEngine.score_patch_maps_mahalanobis`` and the
    served artifact all score through it.  The JAX package computes it in
    f32 at ``Precision.HIGHEST``.  Here the product runs in float64 on the
    queries' device and the result is rounded to f32 once: TF32 never
    enters (``torch.backends.cuda.matmul.allow_tf32`` and
    ``set_float32_matmul_precision`` do not apply to f64), so a score
    cannot fall on the other side of a threshold calibrated with the same
    formula.  On the card f64 runs on the tensor cores; the (Q, 512) ×
    (512, 512) product is a fraction of a millisecond per patch batch."""
    q = torch.as_tensor(queries).double() - mean.double()
    d2 = ((q @ precision.double()) * q).sum(dim=1)
    return torch.sqrt(torch.clamp(d2, min=0.0)).float()


@dataclasses.dataclass
class MahalanobisDetector(_Detector):
    """Gaussian-density anomaly scorer (ssad_tpu/models/detector.py:147-208):
    a single Gaussian fitted to the normality embeddings, scored by
    Mahalanobis distance.  The covariance is shrunk toward trace/D·I
    (a fixed Ledoit-Wolf-style coefficient), which keeps the inverse
    well-conditioned when M < D.  The fit's moments and inverse are
    computed in float64 on the embeddings' device and kept as f32 (the JAX
    detector's dtype and the artifact's), so neither depends on TF32.
    In patch mode ``predict`` reshapes to (batch, 1, side, side) maps."""

    shrinkage: float = 0.1
    patch_level: bool = False
    batch: Optional[int] = None
    num_patches: Optional[int] = None

    mean: Optional[torch.Tensor] = None  # (D,) f32
    precision: Optional[torch.Tensor] = None  # (D, D) f32
    threshold: Optional[float] = None
    #: validation-split scores kept by fit() (see AnomalyDetector)
    calibration_scores: Optional[torch.Tensor] = None

    def fit(self, embeddings: torch.Tensor, generator: Optional[torch.Generator] = None,
            perm: Optional[torch.Tensor] = None,
            coreset: Optional[int] = None) -> "MahalanobisDetector":
        """70/30 split as ``AnomalyDetector.fit`` (all rows train the
        Gaussian when the split would leave fewer than 2), threshold =
        the max validation score.  ``coreset`` is taken so that either
        detector fits through one call, and ignored: the Gaussian's
        moments are fixed size whatever the row count, and a maximin
        subset would bias them toward boundary rows."""
        emb = torch.as_tensor(embeddings).float()
        m, d = emb.shape
        if m < 2:
            raise ValueError("need at least 2 normality embeddings")
        perm = _split(m, generator, perm, emb.device)
        n_val = max(int(round(m * 0.3)), 1)
        train = emb[perm[n_val:]] if m - n_val >= 2 else emb
        val = emb[perm[:n_val]]

        x64 = train.double()
        mu = x64.mean(dim=0)
        x = x64 - mu
        cov = (x.T @ x) / max(train.shape[0] - 1, 1)
        eye = torch.eye(d, dtype=torch.float64, device=emb.device)
        cov = (1.0 - self.shrinkage) * cov + self.shrinkage * (torch.trace(cov) / d) * eye
        self.mean = mu.float()
        self.precision = torch.linalg.inv(cov).float()
        self.calibration_scores = mahalanobis_distances(val, self.mean, self.precision)
        self.threshold = float(torch.max(self.calibration_scores))
        return self

    def score(self, queries: torch.Tensor) -> torch.Tensor:
        """(N, D) → (N,) Mahalanobis distances to the fitted Gaussian."""
        if self.precision is None:
            raise RuntimeError("fit() before predict()")
        return mahalanobis_distances(queries, self.mean, self.precision)

    def arrays(self) -> dict:
        """What makes the fitted detector again (see AnomalyDetector)."""
        return {"mean": self.mean, "precision": self.precision}


def make_detector(scorer: str, k: int = 3, **fields):
    """The detector ``scorer`` names: 'knn' → ``AnomalyDetector(k)``,
    'mahalanobis' → ``MahalanobisDetector``.  ``fields`` are the
    dataclass's: the patch shape for ``fit``, or a fitted detector's
    arrays (``bank``, or ``mean`` and ``precision``) as an artifact holds
    them."""
    if scorer == "knn":
        return AnomalyDetector(k=k, **fields)
    if scorer == "mahalanobis":
        return MahalanobisDetector(**fields)
    raise ValueError(f"unknown scorer {scorer!r}; valid: {', '.join(SCORERS)}")

