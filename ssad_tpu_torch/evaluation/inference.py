"""Inference: the eval-mode forward of one trained model, the patch
path, the dataset predictions and the detector's scores.

Counterpart of ssad_tpu/evaluation/inference.py (InferenceEngine :39-218
without the s2d route, pad_to_batch :221-232, predict_mvtec :235-271,
predict_artificial :274-338, normality_embeddings :341-378,
attach_anomaly_scores :381-435, load_engine :438-446, upsample
:449-458).

Patch mode: the (B, H, W, 3) images are cut into dim×dim windows at a
stride (row-major order), cast to bf16 whatever the compute dtype (as the
JAX engine does), and flattened to one (B·P, dim, dim, 3) batch.  32×32
windows take the fused stem (ops/stem_pool.py: the CUDA kernel on the
card, its plain version on the CPU) and re-enter the model after the
stem's maxpool; other sizes run the module forward.  ``score_maps``
adds a fitted detector's scores per window (models/detector.py), the
(B, side, side) reshape and the blur ⊗ upsample to the image size;
``score_patch_maps`` and ``score_patch_maps_mahalanobis`` are its JAX
names, scoring against a bank and a fitted Gaussian.
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ssad_tpu_torch.config import ModelConfig
from ssad_tpu_torch.constants import ModelOutputs
from ssad_tpu_torch.data import mvtec
from ssad_tpu_torch.data.synthetic import SynthDraws, SynthSpec, draw, synthesize
from ssad_tpu_torch.models.detector import make_detector, mahalanobis_distances
from ssad_tpu_torch.models.peranet import PeraNet, build_model
from ssad_tpu_torch.ops import image as im
from ssad_tpu_torch.ops import stem_pool
from ssad_tpu_torch.ops.knn import knn_cosine_scores
from ssad_tpu_torch.ops.patches import extract_patches
from ssad_tpu_torch.train.memory_bank import MemoryBank, newest_first
from ssad_tpu_torch.utils import convert
from ssad_tpu_torch.utils.device import resolve_device


class InferenceEngine:
    """A PeraNet in eval mode on one device.  32×32 patch batches take the
    fused stem (ops/stem_pool.py)."""

    def __init__(self, model: PeraNet, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self._stem_affine = None  # (folded kernel, scale', bias') on the device

    def predict_batch(self, x_normalized) -> Tuple[torch.Tensor, torch.Tensor]:
        """ImageNet-normalized (B, H, W, 3) → (logits, embeddings), f32 on
        the engine's device."""
        x = torch.as_tensor(x_normalized, dtype=torch.float32).to(self.device)
        with torch.inference_mode():
            out = self.model(x)
        return out["classifier"], out["latent_space"]

    def stem_affine(self):
        """The folded stem kernel and BN affine, computed once in f32."""
        if self._stem_affine is None:
            self._stem_affine = stem_pool.folded_stem_affine(self.model.state_dict())
        return self._stem_affine

    def patch_forward(self, flat: torch.Tensor) -> dict:
        """Forward a (N, d, d, 3) patch batch; 32×32 patches take the
        fused stem."""
        if flat.shape[1] == stem_pool.PATCH and flat.shape[2] == stem_pool.PATCH:
            x_stem = stem_pool.stem_pool(flat, *self.stem_affine())
            return self.model.from_stem(x_stem)
        return self.model(flat)

    def embed_grid(self, x_normalized, dim: int, stride: int):
        """Window extraction (bf16) + forward → (outputs, B, P)."""
        x = torch.as_tensor(x_normalized, dtype=torch.float32).to(self.device)
        p = extract_patches(x.to(torch.bfloat16), dim=dim, stride=stride)
        b, n = p.shape[0], p.shape[1]
        return self.patch_forward(p.reshape((b * n,) + tuple(p.shape[2:]))), b, n

    def predict_patches(self, x_normalized, dim: int = 32, stride: int = 8):
        """(B, H, W, 3) → (logits (B·P, C), embeddings (B·P, D), P), rows
        in row-major window order per image."""
        with torch.inference_mode():
            out, _, n = self.embed_grid(x_normalized, dim, stride)
        return out["classifier"], out["latent_space"], n

    def score_patch_maps(
        self,
        x_normalized,
        bank,
        dim: int = 32,
        stride: int = 8,
        k: int = 3,
        upsample_to: Optional[int] = None,
    ) -> torch.Tensor:
        """(B, side, side) k-NN anomaly maps, or (B, upsample_to,
        upsample_to) blurred and upsampled ones; ``bank`` is an (M, D)
        tensor or its ``ops.knn.TiledBank``."""
        return self.score_maps(x_normalized, lambda emb: knn_cosine_scores(emb, bank, k=k),
                               dim, stride, upsample_to)

    def score_patch_maps_mahalanobis(
        self,
        x_normalized,
        mean: torch.Tensor,
        precision: torch.Tensor,
        dim: int = 32,
        stride: int = 8,
        upsample_to: Optional[int] = None,
    ) -> torch.Tensor:
        """``score_patch_maps`` with the windows scored by Mahalanobis
        distance to a fitted Gaussian (models/detector.py)."""
        return self.score_maps(x_normalized,
                               lambda emb: mahalanobis_distances(emb, mean, precision),
                               dim, stride, upsample_to)

    def score_maps(self, x_normalized, score, dim: int = 32, stride: int = 8,
                   upsample_to: Optional[int] = None) -> torch.Tensor:
        """Windows → stem → PeraNet → ``score`` per window → (B, side,
        side) maps, blurred and upsampled when ``upsample_to`` is given.
        ``score`` maps (N, D) embeddings to (N,) scores: a fitted
        detector's ``score``."""
        with torch.inference_mode():
            out, b, n = self.embed_grid(x_normalized, dim, stride)
            side = int(round(n ** 0.5))
            maps = score(out["latent_space"]).reshape(b, side, side)
            if upsample_to is not None:
                maps = im.upsample_anomaly_maps(maps, upsample_to)
        return maps


def pad_to_batch(x: torch.Tensor, batch_size: int) -> Tuple[torch.Tensor, int]:
    """Zero-pad the leading axis up to ``batch_size``; returns (padded,
    n_real).  Keeps every call at one batch shape, so the convolution
    algorithms chosen for it are the ones every batch runs."""
    n = x.shape[0]
    if n >= batch_size:
        return x, n
    pad = x.new_zeros((batch_size - n,) + tuple(x.shape[1:]))
    return torch.cat([x, pad]), n


def predict_mvtec(engine: InferenceEngine, data: mvtec.MVTecTestData, batch_size: int = 32,
                  patch_localization: bool = False, patch_dim: int = 32,
                  stride: int = 8) -> ModelOutputs:
    """Forward the MVTec test set (reference predict_step's mvtec branch,
    models.py:314-317, and evaluator.py:286-332's patch path): one row per
    image, or with ``patch_localization`` one per window.  Every field on
    the engine's device."""
    chunks = []
    num_classes = engine.model.num_classes
    for lo in range(0, data.images.shape[0], batch_size):
        raw = torch.from_numpy(np.ascontiguousarray(data.images[lo:lo + batch_size]))
        raw = raw.to(engine.device)
        x = im.normalize_imagenet(raw)
        gts = torch.from_numpy(np.ascontiguousarray(data.ground_truths[lo:lo + batch_size]))
        gts = gts.to(engine.device)
        if patch_localization:
            logits, emb, _ = engine.predict_patches(x, patch_dim, stride)
        else:
            logits, emb = engine.predict_batch(x)
        chunks.append(ModelOutputs(
            original_data=raw, tensor_data=x, ground_truths=gts,
            y_true_binary=convert.gt2label(gts),
            y_true_multiclass=convert.gt2label(gts, negative=-1, positive=num_classes),
            raw_predictions=logits, embeddings=emb, y_hat=convert.prediction_class(logits)))
    return ModelOutputs.concat(chunks)


def artificial_batches(spec: SynthSpec, n_images: int, n_cut: int, num_samples: int,
                       batch_size: int, seed: int) -> Iterator[Tuple[torch.Tensor, SynthDraws]]:
    """The host half of ``predict_artificial``: per batch of
    ``batch_size``, the sampled image indices and the synthesis draws,
    from one CPU ``torch.Generator`` seeded with ``seed`` (the JAX package
    splits ``jax.random`` keys instead, so the same seed draws other
    batches)."""
    gen = torch.Generator().manual_seed(seed)
    for _ in range(0, num_samples, batch_size):
        idx = torch.randint(0, n_images, (batch_size,), generator=gen)
        yield idx, draw(spec, batch_size, gen, n_cut=n_cut)


def predict_artificial(engine: InferenceEngine, data: mvtec.PretextData, spec: SynthSpec,
                       num_samples: int = 500, batch_size: int = 32,
                       seed: int = 0) -> ModelOutputs:
    """Forward synthetic pretext batches built from the held-out val split
    of the train-good images (the train split when val is empty), as the
    reference's inference with mvtec_inference=False (tools.py:339-345,
    models.py:318-320).  Draws on the host (``artificial_batches``),
    synthesis and the forward on the engine's device; each batch is
    synthesized at ``batch_size`` and cut to what ``num_samples`` still
    needs."""
    use_val = len(data.val_images) > 0
    images, masks, coords, counts = (
        (data.val_images, data.val_masks, data.val_coords, data.val_counts) if use_val
        else (data.train_images, data.train_masks, data.train_coords, data.train_counts))
    # subjects that pose differently per image use each image's own mask
    # (datasets.py:232-235), the others the subject's fixed one
    per_image = spec.is_non_fixed and masks is not None
    if not per_image:
        masks, coords, counts = data.fixed_mask, data.fixed_coords, np.int32(data.fixed_count)
    dev = engine.device
    images, masks, coords, counts, pool = (
        torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        for a in (images, masks, coords, counts, data.cut_pool))
    chunks, remaining = [], num_samples
    for idx, draws in artificial_batches(spec, images.shape[0], pool.shape[0], num_samples,
                                         batch_size, seed):
        b = min(batch_size, remaining)
        idx = idx.to(dev)
        m, c, n = ((t.index_select(0, idx) for t in (masks, coords, counts)) if per_image
                   else (masks, coords, counts))
        x, y, orig = synthesize(spec, draws.to(dev), images.index_select(0, idx), pool, m, c, n)
        logits, emb = engine.predict_batch(x)
        chunks.append(ModelOutputs(
            original_data=orig[:b], tensor_data=x[:b], y_true_multiclass=y[:b],
            y_true_binary=convert.multiclass2binary(y[:b]), raw_predictions=logits[:b],
            embeddings=emb[:b], y_hat=convert.prediction_class(logits[:b])))
        remaining -= b
    return ModelOutputs.concat(chunks)


def normality_embeddings(
    engine: InferenceEngine,
    bank: Optional[MemoryBank],
    train_images: Optional[np.ndarray] = None,
    batch_size: int = 32,
    min_bank_rows: int = 100,
    max_images: Optional[int] = None,
    seed: int = 0,
    patch_localization: bool = False,
    patch_dim: int = 32,
    stride: int = 8,
) -> torch.Tensor:
    """The bank's rows (newest first) when it holds at least
    ``min_bank_rows``, else embeddings of the raw [0,1] ``train_images``
    (a seeded random sample of ``max_images`` of them when capped): one
    row per image, or with ``patch_localization`` one row per window."""
    if bank is not None and int(bank.count) >= min_bank_rows:
        return newest_first(bank).to(engine.device)
    if train_images is None:
        raise ValueError("the bank is too small and no train_images were given")
    images = train_images
    if max_images is not None and images.shape[0] > max_images:
        pick = np.random.default_rng(seed).choice(
            images.shape[0], size=max_images, replace=False
        )
        images = images[np.sort(pick)]
    embs = []
    for lo in range(0, images.shape[0], batch_size):
        raw = torch.as_tensor(np.asarray(images[lo : lo + batch_size], np.float32))
        raw, b = pad_to_batch(raw.to(engine.device), batch_size)
        xn = im.normalize_imagenet(raw)
        if patch_localization:
            _, emb, per_image = engine.predict_patches(xn, patch_dim, stride)
            embs.append(emb[: b * per_image])
        else:
            _, emb = engine.predict_batch(xn)
            embs.append(emb[:b])
    return torch.cat(embs, dim=0)


#: attach_anomaly_scores has said that a coreset does nothing with the
#: Mahalanobis scorer (the JAX package says it once per process too)
_coreset_noted = False


def attach_anomaly_scores(outputs: ModelOutputs, normality: torch.Tensor,
                          patch_localization: bool = False, num_images: Optional[int] = None,
                          patches_per_image: Optional[int] = None, k: int = 3, seed: int = 0,
                          perm: Optional[torch.Tensor] = None, scorer: str = "knn",
                          coreset: Optional[int] = None):
    """Fit the selected detector on ``normality`` (70/30, the split permuted
    by a CPU ``torch.Generator`` seeded with ``seed``, or by ``perm``) and
    score ``outputs.embeddings`` into ``outputs.anomaly_maps``
    (tools.py:351-389) → (outputs, detector).  ``scorer``: 'knn' (the
    reference detector) or 'mahalanobis'.  ``coreset`` distils the k-NN
    bank inside ``AnomalyDetector.fit`` (after the split); Mahalanobis
    ignores it, with a note once per process: the Gaussian's moments are
    fixed size whatever the row count, and a maximin subset would bias
    them toward boundary rows."""
    global _coreset_noted
    shape = dict(patch_level=patch_localization, batch=num_images,
                 num_patches=patches_per_image)
    detector = make_detector(scorer, k=k, **shape)
    if scorer == "mahalanobis" and coreset is not None and not _coreset_noted:
        _coreset_noted = True
        print("note: coreset has no effect with scorer=mahalanobis (the Gaussian's "
              "moments are fixed size; a maximin subset would bias them) — ignored",
              file=sys.stderr)
    detector.fit(normality, torch.Generator().manual_seed(seed), perm=perm, coreset=coreset)
    outputs.anomaly_maps = detector.predict(outputs.embeddings)
    return outputs, detector


def load_engine(
    checkpoint_path: str | Path, device=None, allow_pickle: bool = False
) -> Tuple[InferenceEngine, Optional[MemoryBank], ModelConfig]:
    """A reference-layout ``best_model.ckpt`` → (engine, bank or None,
    ModelConfig).  The state dict loads with ``strict=True``."""
    from ssad_tpu_torch.utils.ref_checkpoint import load_checkpoint

    dev = resolve_device(device)
    state_dict, bank, cfg, _ = load_checkpoint(checkpoint_path, allow_pickle)
    model = build_model(cfg)
    model.load_state_dict(state_dict, strict=True)
    return InferenceEngine(model, dev), bank, cfg


def upsample(anomaly_maps: torch.Tensor, target_size: int = 256) -> torch.Tensor:
    """Blur → ReLU → bilinear upsample of non-negative k-NN maps
    (reference tools.py:394-399): ``ops.image.upsample_anomaly_maps``."""
    return im.upsample_anomaly_maps(anomaly_maps, target_size)
