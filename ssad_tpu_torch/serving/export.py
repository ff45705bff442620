"""Serving artifacts: one file with the weights, the fitted bank and the
calibrated threshold, and the scorer that serves it.

Counterpart of the k-NN branches of ssad_tpu/serving/export.py (image and
patch mode).  The JAX artifact carries a serialized StableHLO program;
PyTorch runs eagerly, so this one carries the model's state dict instead
and ``ServedScorer`` rebuilds PeraNet on the device.  The layout is

  SSADPT01 | u64 header_len | header JSON | torch.save payload

with the JAX header's fields (mode, batch, imsize, k, threshold, knn_impl,
weights_dtype, scorer, num_classes, subject, calibration, …), the port's
own ``format`` string, ``platform: "cuda"`` and the model configuration,
and a payload ``{"state_dict": …, "bank": (M, D) float32}``.

The scorer maps RAW [0,1] float images (B, H, W, 3), after ImageNet
normalization, to

* image mode: ``(scores (B,), labels (B,), logits (B, C))`` — the PeraNet
  forward in eval mode, k-NN cosine scoring against the f32 bank, the
  threshold;
* patch mode: ``(maps (B, H, W),)`` — the patch path of
  evaluation/inference.py (windows → fused stem → PeraNet → k-NN against
  the patch bank → blur ⊗ upsample to the image size).

On the card every kernel of the path is the CUDA one; on the CPU it is
the plain version.  The header's ``knn_impl`` names the k-NN kernel that
serves the bank: ``cuda`` (≤ 1024 rows, csrc/knn.cu) or ``cuda_tiled``
(csrc/knn_tiled.cu).
"""

from __future__ import annotations

import dataclasses
import io
import json
import struct
import time
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from ssad_tpu_torch.config import DataConfig, EvalConfig, ModelConfig
from ssad_tpu_torch.evaluation.inference import InferenceEngine
from ssad_tpu_torch.models.peranet import build_model
from ssad_tpu_torch.ops import image as im
from ssad_tpu_torch.ops.knn import PALLAS_MAX_BANK_ROWS, knn_cosine_scores, prepare_bank
from ssad_tpu_torch.utils.device import resolve_device

_MAGIC = b"SSADPT01"
FORMAT = "ssad_tpu_torch.serving/1"


def save_artifact(path: str | Path, meta: dict, state_dict: dict, bank: torch.Tensor) -> str:
    buf = io.BytesIO()
    torch.save(
        {
            "state_dict": {k: v.detach().cpu() for k, v in state_dict.items()},
            "bank": bank.detach().to("cpu", torch.float32).contiguous(),
        },
        buf,
    )
    header = json.dumps(meta).encode("utf-8")
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<Q", len(header)))
        f.write(header)
        f.write(buf.getvalue())
    return str(path)


def read_artifact(path: str | Path) -> Tuple[dict, dict]:
    """(header, payload) of an artifact file."""
    blob = Path(path).read_bytes()
    if blob[: len(_MAGIC)] != _MAGIC:
        raise ValueError(f"{path}: not an ssad_tpu_torch serving artifact")
    off = len(_MAGIC)
    (hlen,) = struct.unpack_from("<Q", blob, off)
    off += 8
    meta = json.loads(blob[off : off + hlen].decode("utf-8"))
    payload = torch.load(io.BytesIO(blob[off + hlen :]), map_location="cpu", weights_only=True)
    return meta, payload


def export_checkpoint(
    checkpoint_path: str | Path,
    out_path: str | Path,
    mode: str = "image",
    batch: int = 8,
    imsize: Optional[Tuple[int, int]] = None,
    k: Optional[int] = None,
    normality=None,
    threshold: Optional[float] = None,
    seed: int = 0,
    subject: Optional[str] = None,
    device=None,
    allow_pickle: bool = False,
    dataset_dir: Optional[str | Path] = None,
    n_normality_images: Optional[int] = None,
    patch_dim: int = 32,
    stride: int = 8,
) -> str:
    """Reference-layout ``best_model.ckpt`` → serving artifact.

    The detector is fitted here, once, on ``device``: a 70/30 split from a
    generator seeded with ``seed``, the threshold from the validation
    part.  Its normality (unless an explicit ``normality`` array is given):

    * image mode — the checkpoint's memory bank, newest first;
    * patch mode — patch embeddings re-embedded from the training images
      of ``<dataset_dir>/<subject>/train/good`` (at most
      ``n_normality_images`` of them, a seeded sample), four images per
      forward: the bank holds whole-image embeddings, the wrong
      distribution for patch scoring.

    On the card the fit's scoring runs the k-NN kernel for the bank's size.
    """
    from ssad_tpu_torch.models.detector import AnomalyDetector
    from ssad_tpu_torch.train.memory_bank import newest_first
    from ssad_tpu_torch.utils.ref_checkpoint import load_reference_checkpoint

    if mode not in ("image", "patch"):
        raise ValueError(f"unknown mode {mode!r}; valid: image, patch")
    dev = resolve_device(device)
    state_dict, bank, cfg = load_reference_checkpoint(checkpoint_path, allow_pickle)
    imsize = tuple(imsize or DataConfig().imsize)
    engine = data = None
    if mode == "patch":
        model = build_model(cfg)
        model.load_state_dict(state_dict, strict=True)
        engine = InferenceEngine(model, dev)
    if normality is None:
        if mode == "patch":
            normality, data = _patch_normality(
                engine, dataset_dir, subject, imsize, n_normality_images, patch_dim, stride, seed
            )
        else:
            if bank is None or int(bank.count) == 0:
                raise ValueError(f"{checkpoint_path} has no memory bank; pass `normality`")
            normality = newest_first(bank)
    k = EvalConfig().knn_k if k is None else k
    det = AnomalyDetector(k=k).fit(
        torch.as_tensor(normality, dtype=torch.float32).to(dev),
        generator=torch.Generator().manual_seed(seed),
    )
    upsample_to = imsize[0] if mode == "patch" else None
    meta = {
        "format": FORMAT,
        "mode": mode,
        "batch": int(batch),
        "imsize": list(imsize),
        "k": int(k),
        "threshold": float(det.threshold if threshold is None else threshold),
        "patch_dim": int(patch_dim),
        "stride": int(stride),
        "upsample_to": upsample_to,
        "platform": "cuda",
        "knn_impl": "cuda_tiled" if det.bank.shape[0] > PALLAS_MAX_BANK_ROWS else "cuda",
        "weights_dtype": "float32",
        "scorer": "knn",
        "num_classes": cfg.num_classes,
        "model": dataclasses.asdict(cfg),
        "checkpoint": str(checkpoint_path),
        "calibration": _calibration_summary(det, mode, engine, data, patch_dim, stride,
                                            upsample_to),
    }
    if subject:
        meta["subject"] = subject
    return save_artifact(out_path, meta, state_dict, det.bank)


def _patch_normality(engine, dataset_dir, subject, imsize, n_images, patch_dim, stride, seed):
    """(patch embeddings of the subject's training images, SplitImages)."""
    from ssad_tpu_torch.data.mvtec import load_split
    from ssad_tpu_torch.evaluation.inference import normality_embeddings

    if dataset_dir is None or not subject:
        raise ValueError(
            "patch-mode export needs patch-embedding normality: pass dataset_dir and "
            "subject (to re-embed the training images) or an explicit `normality` "
            "array; the checkpoint's memory bank holds whole-image embeddings"
        )
    data = load_split(dataset_dir, subject, imsize=imsize)
    emb = normality_embeddings(
        engine, None, data.train_images, batch_size=4, min_bank_rows=10**9,
        max_images=n_images, seed=seed, patch_localization=True, patch_dim=patch_dim,
        stride=stride,
    )
    return emb, data


def _calibration_summary(det, mode, engine, data, patch_dim, stride, upsample_to,
                         max_images: int = 32):
    """The drift baseline of the header (serving/drift.py): quantiles of
    the quantity the server observes per request.

    * image mode — the fit's validation-split scores;
    * patch mode — anomaly-map maxima of at most ``max_images`` held-out
      training images (the train split when there is no val split),
      scored in chunks of 4 (the last padded by repeating its final
      image) through the patch path with the fitted bank; None when only
      an explicit normality array was given.
    """
    from ssad_tpu_torch.serving.drift import quantile_summary

    if mode == "image":
        summary = quantile_summary(det.calibration_scores.cpu().numpy())
        summary["source"] = "fit-val-knn"
        return summary
    if data is None:
        return None
    images = data.val_images if len(data.val_images) else data.train_images
    images = images[:max_images]
    bank = prepare_bank(det.bank)  # split once for all the chunks
    maxima = []
    for lo in range(0, images.shape[0], 4):
        chunk = images[lo : lo + 4]
        n_real = chunk.shape[0]
        if n_real < 4:
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], 4 - n_real, axis=0)])
        x = torch.from_numpy(np.ascontiguousarray(chunk, np.float32)).to(engine.device)
        maps = engine.score_patch_maps(
            im.normalize_imagenet(x), bank, dim=patch_dim, stride=stride, k=det.k,
            upsample_to=upsample_to,
        )
        maxima.extend(maps.amax(dim=(1, 2))[:n_real].cpu().tolist())
    summary = quantile_summary(maxima)
    summary["source"] = "val-image-map-max-knn"
    return summary


def warm_call(call, x, max_calls: int = 16, settled_s: float = 0.25) -> float:
    """Run ``call(x)`` until one call takes under ``settled_s``; returns
    the seconds spent.  The first calls on the card pay cuDNN's algorithm
    selection and the kernel's build, which must not land on a request."""
    t0 = time.perf_counter()
    for _ in range(max_calls):
        t1 = time.perf_counter()
        call(x)
        if time.perf_counter() - t1 < settled_s:
            break
    return time.perf_counter() - t0


class ServedScorer:
    """An artifact rebuilt on one device, callable on numpy image batches.

    Sub-``batch`` inputs are zero-padded to the artifact's batch and the
    padding rows dropped from the outputs; larger inputs are chunked.
    On a CUDA device every kernel of the path is the CUDA one; on the CPU
    it is the plain version.  ``bank`` stays the raw f32 bank;
    ``knn_bank`` is what the k-NN scoring takes (``prepare_bank``: on the
    card a bank above PALLAS_MAX_BANK_ROWS rows is normalised and split
    here, once, instead of on every call).
    """

    def __init__(self, meta: dict, state_dict: dict, bank: torch.Tensor, device=None):
        self.meta = meta
        self.device = resolve_device(device)
        model = build_model(ModelConfig(**_tuples(meta["model"])))
        model.load_state_dict(state_dict, strict=True)
        self.engine = InferenceEngine(model, self.device)
        self.bank = bank.to(self.device, torch.float32).contiguous()
        self.knn_bank = prepare_bank(self.bank)
        self.k = int(meta["k"])
        self.threshold = float(meta["threshold"])

    @classmethod
    def from_file(cls, path: str | Path, device=None) -> "ServedScorer":
        dev = resolve_device(device)
        meta, payload = read_artifact(path)
        return cls(meta, payload["state_dict"], payload["bank"], dev)

    @property
    def batch(self) -> int:
        return int(self.meta["batch"])

    def score_tensor(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """(B, H, W, 3) raw images on the device → device tensors:
        (scores, labels, logits) in image mode, (maps,) in patch mode."""
        meta = self.meta
        if meta["mode"] == "patch":
            maps = self.engine.score_patch_maps(
                im.normalize_imagenet(x), self.knn_bank, dim=int(meta["patch_dim"]),
                stride=int(meta["stride"]), k=self.k, upsample_to=meta["upsample_to"],
            )
            return (maps,)
        with torch.inference_mode():
            logits, emb = self.engine.predict_batch(im.normalize_imagenet(x))
            scores = knn_cosine_scores(emb, self.knn_bank, k=self.k)
            labels = (scores > self.threshold).to(torch.int32)
        return scores, labels, logits

    def warmup(self, max_calls: int = 16, settled_s: float = 0.25) -> float:
        h, w = self.meta["imsize"]
        x = np.zeros((self.batch, h, w, 3), np.float32)
        return warm_call(self, x, max_calls=max_calls, settled_s=settled_s)

    def __call__(self, images: np.ndarray) -> Tuple[np.ndarray, ...]:
        x = np.asarray(images, dtype=np.float32)
        if x.ndim == 3:
            x = x[None]
        h, w = self.meta["imsize"]
        if x.shape[1:] != (h, w, 3):
            raise ValueError(f"expected (B, {h}, {w}, 3) images, got {x.shape}")
        if x.shape[0] == 0:
            raise ValueError("cannot score an empty batch (0 images)")
        # queue chunk i+1 on the device before reading chunk i back, so
        # the host copy of one chunk overlaps the next chunk's kernels
        outs = []
        pending = None  # (device results, valid rows)
        for lo in range(0, x.shape[0], self.batch):
            chunk = x[lo : lo + self.batch]
            n = chunk.shape[0]
            if n < self.batch:
                chunk = np.pad(chunk, ((0, self.batch - n),) + ((0, 0),) * 3)
            res = self.score_tensor(torch.from_numpy(chunk).to(self.device))
            if pending is not None:
                outs.append(_to_host(*pending))
            pending = (res, n)
        outs.append(_to_host(*pending))
        return tuple(np.concatenate(parts, axis=0) for parts in zip(*outs))


def _to_host(res, n: int) -> Tuple[np.ndarray, ...]:
    return tuple(r[:n].cpu().numpy() for r in res)


def _tuples(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def load_scorer(path: str | Path, device=None) -> ServedScorer:
    return ServedScorer.from_file(path, device)
