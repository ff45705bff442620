"""Inference: the eval-mode forward of one trained model, the patch
path, and the normality source for the detector.

Counterpart of ssad_tpu/evaluation/inference.py (InferenceEngine :39-218
without the Mahalanobis and s2d routes, pad_to_batch :221-232,
normality_embeddings :341-378, load_engine :438-446).

Patch mode: the (B, H, W, 3) images are cut into dim×dim windows at a
stride (row-major order), cast to bf16 whatever the compute dtype (as the
JAX engine does), and flattened to one (B·P, dim, dim, 3) batch.  32×32
windows take the fused stem (ops/stem_pool.py: the CUDA kernel on the
card, its plain version on the CPU) and re-enter the model after the
stem's maxpool; other sizes run the module forward.  ``score_patch_maps``
adds k-NN scoring against a bank, the (B, side, side) reshape and the
blur ⊗ upsample to the image size.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from ssad_tpu_torch.config import ModelConfig
from ssad_tpu_torch.models.peranet import PeraNet, build_model
from ssad_tpu_torch.ops import image as im
from ssad_tpu_torch.ops import stem_pool
from ssad_tpu_torch.ops.knn import knn_cosine_scores
from ssad_tpu_torch.ops.patches import extract_patches
from ssad_tpu_torch.train.memory_bank import MemoryBank, newest_first
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
        with torch.inference_mode():
            out, b, n = self.embed_grid(x_normalized, dim, stride)
            scores = knn_cosine_scores(out["latent_space"], bank, k=k)
            side = int(round(n ** 0.5))
            maps = scores.reshape(b, side, side)
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
