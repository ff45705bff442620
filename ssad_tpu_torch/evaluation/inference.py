"""Inference: the eval-mode forward of one trained model, and the
normality source for the detector.

Counterpart of the image branch of ssad_tpu/evaluation/inference.py
(InferenceEngine.predict_batch :39-183, pad_to_batch :221-232,
normality_embeddings :341-378, load_engine :438-446).  The patch path
(predict_patches, score_patch_maps) waits for the patch slice.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from ssad_tpu_torch.config import ModelConfig
from ssad_tpu_torch.models.peranet import PeraNet, build_model
from ssad_tpu_torch.ops import image as im
from ssad_tpu_torch.train.memory_bank import MemoryBank, newest_first
from ssad_tpu_torch.utils.device import resolve_device


class InferenceEngine:
    """A PeraNet in eval mode on one device."""

    def __init__(self, model: PeraNet, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()

    def predict_batch(self, x_normalized) -> Tuple[torch.Tensor, torch.Tensor]:
        """ImageNet-normalized (B, H, W, 3) → (logits, embeddings), f32 on
        the engine's device."""
        x = torch.as_tensor(x_normalized, dtype=torch.float32).to(self.device)
        with torch.inference_mode():
            out = self.model(x)
        return out["classifier"], out["latent_space"]


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
) -> torch.Tensor:
    """The bank's rows (newest first) when it holds at least
    ``min_bank_rows``, else embeddings of the raw [0,1] ``train_images``
    (a seeded random sample of ``max_images`` of them when capped)."""
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
        _, emb = engine.predict_batch(im.normalize_imagenet(raw))
        embs.append(emb[:b])
    return torch.cat(embs, dim=0)


def load_engine(
    checkpoint_path: str | Path, device=None, allow_pickle: bool = False
) -> Tuple[InferenceEngine, Optional[MemoryBank], ModelConfig]:
    """A reference-layout ``best_model.ckpt`` → (engine, bank or None,
    ModelConfig).  The state dict loads with ``strict=True``."""
    from ssad_tpu_torch.utils.ref_checkpoint import load_reference_checkpoint

    dev = resolve_device(device)
    state_dict, bank, cfg = load_reference_checkpoint(checkpoint_path, allow_pickle)
    model = build_model(cfg)
    model.load_state_dict(state_dict, strict=True)
    return InferenceEngine(model, dev), bank, cfg
