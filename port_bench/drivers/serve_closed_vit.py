"""Closed-loop image serving on a transformer trunk: ``serve_closed``'s
window, set-up and checks, with the weights and the plain reference of a
PeraNet on DINOv2's ViT (``reference/vit.py``).

Loaded through ``manifest.driver`` and reused as they are:
``serve_closed``'s ``drive``, ``compare``, ``program_outputs``, ``sample``,
``free`` and ``TimedScorer``.  This file gives ``shapes`` (the state
dict's keys, DINOv2's), ``build_scorer`` (``serve_closed``'s export steps
in memory, image mode, with the model built on the card: drawing the
initial values of 1.1 B parameters on the host, only to overwrite them,
took about 9 of the set-up's 24 s), ``reference_outputs`` (the normality, split, bank,
threshold and sampled verdicts worked out again in float32), and ``run``:
``serve_closed.run`` on a private instance of that module whose
``shapes``, ``build_scorer`` and ``reference_outputs`` are this file's.
The names are ``serve_closed``'s, so ``control.py`` runs this driver
unchanged.

Traffic parameters: ``serve_closed``'s image mode (``imsize`` a multiple
of 14).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from port_bench.core import manifest, seeded
from port_bench.reference import peranet as ref_net
from port_bench.reference import scoring as ref
from port_bench.reference import vit as ref_vit

#: this driver's own instance of serve_closed (its module-level names are
#: rebound below, so no other loader of that driver sees the change)
_closed = manifest.driver("serve_closed")
drive = _closed.drive
compare = _closed.compare
program_outputs = _closed.program_outputs
sample = _closed.sample
free = _closed.free
TimedScorer = _closed.TimedScorer

def shapes(cfg: dict):
    return ref_vit.state_shapes(cfg["backbone"], cfg["layer_outputs"],
                                cfg["latent_space_layers"], cfg["latent_dim"],
                                cfg["num_classes"])


def build_scorer(cfg: dict, tr: dict, state: Dict[str, torch.Tensor], seed: int, device,
                 weights_dtype: Optional[str] = None, phases: Optional[dict] = None):
    """(ServedScorer, bank rows, the fit's threshold): ``serve_closed.
    build_scorer`` in image mode, the model built on ``device``."""
    from ssad_tpu_torch.evaluation.inference import InferenceEngine, normality_embeddings
    from ssad_tpu_torch.models.detector import make_detector
    from ssad_tpu_torch.models.peranet import build_model
    from ssad_tpu_torch.serving.export import ServedScorer, serving_weights

    phases = {} if phases is None else phases
    t = time.perf_counter()
    mcfg = _closed.model_config(cfg)
    with torch.device(device):  # the initial values are overwritten: draw them there
        model = build_model(mcfg)
    model.load_state_dict(state, strict=True)
    engine = InferenceEngine(model, device)
    size = tr["imsize"]
    normal_images = seeded.images(tr["normality_images"], size, seed, "normality", device)
    normality = normality_embeddings(engine, None, normal_images.cpu().numpy(),
                                     batch_size=tr["normality_batch"], min_bank_rows=10**9)
    del normal_images, engine, model
    t, phases["normality_s"] = time.perf_counter(), time.perf_counter() - t
    det = make_detector("knn", k=cfg["knn_k"])
    det.fit(normality, torch.Generator().manual_seed(seeded.stream(seed, "split")))
    bank, threshold = det.bank, float(det.threshold)
    del normality, det
    t, phases["fit_s"] = time.perf_counter(), time.perf_counter() - t
    meta = {
        "mode": "image", "batch": tr["batch"], "imsize": [size, size], "k": cfg["knn_k"],
        "threshold": threshold, "patch_dim": 32, "stride": 8, "upsample_to": None,
        "scorer": "knn", "model": dataclasses.asdict(mcfg),
        "weights_dtype": weights_dtype or "float32",
    }
    weights, scales = serving_weights(state, weights_dtype)
    scorer = ServedScorer(meta, weights, device, scales=scales, bank=bank)
    phases["scorer_s"] = time.perf_counter() - t
    return scorer, int(bank.shape[0]), threshold


def reference_outputs(cfg: dict, tr: dict, seed: int, device, pool_index: np.ndarray,
                      precision: ref_net.Precision = ref_net.Precision(),
                      flip_band: float = 0.0) -> dict:
    """The plain reference's verdicts for the pool images ``pool_index``,
    everything worked out again from the seeded weights and images."""
    net = ref_vit.ViTPeraNetReference(seeded.fill_state(shapes(cfg), seed, device),
                                      cfg["backbone"], cfg["layer_outputs"],
                                      cfg["latent_space_layers"], precision)
    size, k = tr["imsize"], cfg["knn_k"]
    normality = ref.embed(net, seeded.images(tr["normality_images"], size, seed, "normality",
                                             device))
    bank, threshold = ref.fit(normality, k, seeded.stream(seed, "split"), precision)
    del normality
    picked = seeded.images(tr["pool_images"], size, seed, "requests", device)[
        torch.as_tensor(pool_index, device=device)]
    logits, emb = net.forward(ref_net.normalize(picked))
    scores = ref.knn_scores(emb, bank, k, precision)
    return {"scores": scores.double().cpu(), "logits": logits.double().cpu(),
            "labels": (scores > threshold).cpu(), "threshold": threshold,
            "flip_band": flip_band}


_closed.shapes = shapes
_closed.build_scorer = build_scorer
_closed.reference_outputs = reference_outputs


def run(cell, seed: int, seconds: float, trace: bool, device) -> dict:
    """``serve_closed.run`` with this file's weights and reference."""
    return _closed.run(cell, seed, seconds, trace, device)
