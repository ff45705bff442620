"""Serving artifacts: one file with the weights, the fitted scorer (a k-NN
bank, or a Gaussian's mean and precision) and the calibrated threshold,
and the scorer that serves it.

Counterpart of ssad_tpu/serving/export.py for the k-NN and Mahalanobis
scorers in image and patch mode, with float32, bfloat16 or int8 weights
(``dtype``, :69-95).  The JAX artifact carries a serialized StableHLO program;
PyTorch runs eagerly, so this one carries the model's state dict instead
and ``ServedScorer`` rebuilds PeraNet on the device.  The layout is

  SSADPT01 | u64 header_len | header JSON | torch.save payload

with the JAX header's fields (mode, batch, imsize, k, threshold, knn_impl,
weights_dtype, scorer, num_classes, subject, calibration, …), the port's
own ``format`` string, ``platform: "cuda"`` and the model configuration
(its ``backbone`` among it, read from the checkpoint's TrainConfig), and a
payload ``{"state_dict": …, "bank": (M, D) float32}`` — or, when the
header's ``scorer`` is ``"mahalanobis"`` (and its ``knn_impl`` null),
``{"state_dict": …, "mean": (D,), "precision": (D, D)}`` float32.

The header's ``weights_dtype`` says how the state dict is stored:
``float32``; ``bfloat16``, every floating tensor cast (half the bytes);
or ``int8``, every tensor with two or more axes quantized per output
channel (serving/quant.py, about a quarter of the bytes) with its scales
under the payload's ``scales``.  The bank and the k-NN stay float32:
scores are 1 − cos with cos ≈ 1.  ``ServedScorer`` loads either back as
bf16 values into the model's float32 parameters on the device, once.

The scorer maps RAW [0,1] float images (B, H, W, 3), after ImageNet
normalization, to

* image mode: ``(scores (B,), labels (B,), logits (B, C))`` — the PeraNet
  forward in eval mode, k-NN cosine scoring against the f32 bank (or
  ``models.detector.mahalanobis_distances``), the threshold;
* patch mode: ``(maps (B, H, W),)`` — the patch path of
  evaluation/inference.py (windows → fused stem → PeraNet → k-NN against
  the patch bank, or Mahalanobis → blur ⊗ upsample to the image size).

On the card every kernel of the path is the CUDA one; on the CPU it is
the plain version.  The header's ``knn_impl`` names the k-NN kernel that
serves the bank: ``cuda`` (≤ 1024 rows, csrc/knn.cu) or ``cuda_tiled``
(csrc/knn_tiled.cu); it is null for a Mahalanobis artifact, which runs
no k-NN.
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
from ssad_tpu_torch.models.detector import make_detector
from ssad_tpu_torch.models.peranet import build_model
from ssad_tpu_torch.ops import image as im
from ssad_tpu_torch.ops.knn import PALLAS_MAX_BANK_ROWS
from ssad_tpu_torch.utils.device import resolve_device

_MAGIC = b"SSADPT01"
FORMAT = "ssad_tpu_torch.serving/1"


#: the serving weight dtypes of ``export_checkpoint`` (None is float32)
WEIGHT_DTYPES = ("bfloat16", "int8")


def save_artifact(path: str | Path, meta: dict, state_dict: dict,
                  scales: Optional[dict] = None, **arrays: torch.Tensor) -> str:
    """Write an artifact; ``arrays`` are the scorer's: ``bank=`` (k-NN) or
    ``mean=`` and ``precision=`` (Mahalanobis), stored as f32; ``scales``
    the int8 weights' per-channel scales."""
    buf = io.BytesIO()
    payload = {"state_dict": {k: v.detach().cpu() for k, v in state_dict.items()}}
    if scales:
        payload["scales"] = {k: v.detach().cpu() for k, v in scales.items()}
    payload.update({k: v.detach().to("cpu", torch.float32).contiguous()
                    for k, v in arrays.items()})
    torch.save(payload, buf)
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


def serving_weights(state_dict: dict, dtype: Optional[str]) -> Tuple[dict, Optional[dict]]:
    """The state dict as an artifact stores it for ``dtype`` → (tensors,
    int8 scales or None)."""
    if dtype is None or dtype == "float32":
        return state_dict, None
    if dtype == "bfloat16":
        return {k: v.to(torch.bfloat16) if v.is_floating_point() else v
                for k, v in state_dict.items()}, None
    if dtype == "int8":
        from ssad_tpu_torch.serving.quant import quantize_state_dict

        return quantize_state_dict(state_dict)
    raise ValueError(f"unknown weights dtype {dtype!r}; valid: None, {', '.join(WEIGHT_DTYPES)}")


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
    scorer: str = "knn",
    coreset: Optional[int] = None,
    dtype: Optional[str] = None,
) -> str:
    """Reference-layout ``best_model.ckpt`` → serving artifact.

    ``imsize`` and ``subject``: an explicit argument wins; else the
    checkpoint's TrainConfig (the port's own checkpoints carry one); else
    ``DataConfig()``'s imsize and no subject
    (ssad_tpu/serving/export.py:410-412, :479-480).

    The detector is fitted here, once, on ``device``: a 70/30 split from a
    generator seeded with ``seed``, the threshold from the validation
    part.  Its normality (unless an explicit ``normality`` array is given):

    * image mode — the checkpoint's memory bank, newest first;
    * patch mode — patch embeddings re-embedded from the training images
      of ``<dataset_dir>/<subject>/train/good`` (at most
      ``n_normality_images`` of them, a seeded sample), four images per
      forward: the bank holds whole-image embeddings, the wrong
      distribution for patch scoring.

    ``scorer``: 'knn' (the bank; ``coreset`` distils it inside the fit,
    after the split) or 'mahalanobis' (a Gaussian; ``coreset`` is ignored:
    its moments are fixed size, and a maximin subset would bias them).
    On the card the k-NN fit's scoring runs the k-NN kernel for the bank's
    size.  ``dtype`` ('bfloat16', 'int8' or None for float32) is the
    stored weights' (the normality is embedded with the checkpoint's own
    weights whatever it is).
    """
    from ssad_tpu_torch.train.memory_bank import newest_first
    from ssad_tpu_torch.utils.ref_checkpoint import load_checkpoint

    if mode not in ("image", "patch"):
        raise ValueError(f"unknown mode {mode!r}; valid: image, patch")
    if dtype not in (None, "float32") + WEIGHT_DTYPES:
        raise ValueError(f"unknown weights dtype {dtype!r}; valid: None, "
                         f"{', '.join(WEIGHT_DTYPES)}")
    k = EvalConfig().knn_k if k is None else k
    det = make_detector(scorer, k=k)
    dev = resolve_device(device)
    state_dict, bank, cfg, train_cfg = load_checkpoint(checkpoint_path, allow_pickle)
    data_cfg = train_cfg.data if train_cfg is not None else DataConfig()
    imsize = tuple(imsize or data_cfg.imsize)
    subject = subject or (train_cfg.data.subject if train_cfg is not None else None)
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
    normality = torch.as_tensor(normality, dtype=torch.float32).to(dev)
    det.fit(normality, torch.Generator().manual_seed(seed), coreset=coreset)
    arrays = det.arrays()
    knn_impl = (None if "bank" not in arrays else
                "cuda_tiled" if det.bank.shape[0] > PALLAS_MAX_BANK_ROWS else "cuda")
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
        "knn_impl": knn_impl,
        "weights_dtype": dtype or "float32",
        "scorer": scorer,
        "num_classes": cfg.num_classes,
        "model": dataclasses.asdict(cfg),
        "checkpoint": str(checkpoint_path),
        "calibration": _calibration_summary(det, scorer, mode, engine, data, patch_dim,
                                            stride, upsample_to),
    }
    if subject:
        meta["subject"] = subject
    weights, scales = serving_weights(state_dict, dtype)
    return save_artifact(out_path, meta, weights, scales, **arrays)


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


def _calibration_summary(det, scorer, mode, engine, data, patch_dim, stride, upsample_to,
                         max_images: int = 32):
    """The drift baseline of the header (serving/drift.py): quantiles of
    the quantity the server observes per request.

    * image mode — the fit's validation-split scores;
    * patch mode — anomaly-map maxima of at most ``max_images`` held-out
      training images (the train split when there is no val split),
      scored in chunks of 4 (the last padded by repeating its final
      image) through the patch path with the fitted detector; None when
      only an explicit normality array was given.
    """
    from ssad_tpu_torch.serving.drift import quantile_summary

    if mode == "image":
        summary = quantile_summary(det.calibration_scores.cpu().numpy())
        summary["source"] = f"fit-val-{scorer}"
        return summary
    if data is None:
        return None
    images = data.val_images if len(data.val_images) else data.train_images
    images = images[:max_images]
    maxima = []
    for lo in range(0, images.shape[0], 4):
        chunk = images[lo : lo + 4]
        n_real = chunk.shape[0]
        if n_real < 4:
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], 4 - n_real, axis=0)])
        x = torch.from_numpy(np.ascontiguousarray(chunk, np.float32)).to(engine.device)
        maps = engine.score_maps(im.normalize_imagenet(x), det.score, dim=patch_dim,
                                 stride=stride, upsample_to=upsample_to)
        maxima.extend(maps.amax(dim=(1, 2))[:n_real].cpu().tolist())
    summary = quantile_summary(maxima)
    summary["source"] = f"val-image-map-max-{scorer}"
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
    it is the plain version.  ``detector`` is the fitted detector the
    header's ``scorer`` names ('knn' when an older header has none), made
    from the payload's arrays on the device: its ``score`` is the one
    scoring call of both modes (k-NN: on the card a bank above
    PALLAS_MAX_BANK_ROWS rows is normalised and split once, on the first
    call, which the warmup makes).
    """

    def __init__(self, meta: dict, state_dict: dict, device=None, scales=None, **arrays):
        self.meta = meta
        self.device = resolve_device(device)
        model = build_model(ModelConfig(**_tuples(meta["model"]))).to(self.device)
        state_dict = {k: v.to(self.device) for k, v in state_dict.items()}
        if scales:
            from ssad_tpu_torch.serving.quant import dequantize_state_dict

            state_dict = dequantize_state_dict(state_dict, scales)
        # bf16 values (a bfloat16 or int8 artifact) load into the float32
        # parameters exactly
        model.load_state_dict(state_dict, strict=True)
        self.engine = InferenceEngine(model, self.device)
        self.scorer = meta.get("scorer", "knn")
        self.k = int(meta["k"])
        self.detector = make_detector(self.scorer, k=self.k, **{
            name: a.to(self.device, torch.float32).contiguous() for name, a in arrays.items()})
        self.threshold = float(meta["threshold"])

    @classmethod
    def from_file(cls, path: str | Path, device=None) -> "ServedScorer":
        dev = resolve_device(device)
        meta, payload = read_artifact(path)
        state_dict = payload.pop("state_dict")
        return cls(meta, state_dict, dev, **payload)

    @property
    def batch(self) -> int:
        return int(self.meta["batch"])

    def score_tensor(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """(B, H, W, 3) raw images on the device → device tensors:
        (scores, labels, logits) in image mode, (maps,) in patch mode."""
        meta = self.meta
        xn = im.normalize_imagenet(x)
        if meta["mode"] == "patch":
            geometry = dict(dim=int(meta["patch_dim"]), stride=int(meta["stride"]),
                            upsample_to=meta["upsample_to"])
            return (self.engine.score_maps(xn, self.detector.score, **geometry),)
        with torch.inference_mode():
            logits, emb = self.engine.predict_batch(xn)
            scores = self.detector.score(emb)
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
