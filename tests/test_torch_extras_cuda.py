"""Localization, t-SNE and the quantized artifacts on the card, against the
CPU port.  Every test here takes the ``cuda_device`` fixture and skips
where there is no card.

This file imports neither JAX nor the JAX package, so it also runs on a
machine without them:  python -m pytest --noconftest tests/test_torch_extras_cuda.py
Tolerances: the patch-level localizer's maps (f32 model, TF32 off) 1e-3,
chip_smoke.py's ``PATCH_F32_MODEL_TOL`` (the stem rounds to bf16 and may
flip a value by one ulp on one side); an int8 artifact's image scores
1e-4 (f32 compute on bf16 weights dequantized on each device, TF32
off); the t-SNE on the card finite, and its classes as far apart as on
the CPU (each point nearer its own class centroid than half the mean
distance to the others).
"""

import numpy as np
import pytest
import torch
from _torch_port import cuda_device  # noqa: F401  (fixture)

from ssad_tpu_torch.config import EvalConfig, ModelConfig
from ssad_tpu_torch.evaluation.inference import InferenceEngine
from ssad_tpu_torch.evaluation.localizer import Localizer
from ssad_tpu_torch.evaluation.tsne import tsne
from ssad_tpu_torch.models.peranet import build_model, init_model


@pytest.fixture()
def no_tf32():
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


class _Split:
    def __init__(self, images):
        self.train_images = images


def _images(n, seed, side=128):
    return np.random.default_rng(seed).uniform(size=(n, side, side, 3)).astype(np.float32)


def test_patch_localizer_maps_match_the_cpu(cuda_device, no_tf32):
    sd = init_model(build_model(ModelConfig(compute_dtype="float32")),
                    torch.Generator().manual_seed(0)).state_dict()
    cfg = EvalConfig(patch_localization=True, imsize=(128, 128))
    train, test = _images(4, 1), _images(2, 2)
    maps = {}
    for dev in (cuda_device, torch.device("cpu")):
        model = build_model(ModelConfig(compute_dtype="float32"))
        model.load_state_dict(sd)
        n = 3 * 13 * 13
        loc = Localizer(InferenceEngine(model, dev), cfg).setup(
            _Split(train), perm=torch.randperm(n, generator=torch.Generator().manual_seed(3)))
        maps[dev.type] = np.stack([loc.anomaly_map(img) for img in test])
    assert np.isfinite(maps["cuda"]).all()
    assert float(np.abs(maps["cuda"] - maps["cpu"]).max()) <= 1e-3


def _separation(pts, labels, classes):
    cents = np.stack([pts[labels == c].mean(axis=0) for c in range(classes)])
    d = np.linalg.norm(pts[:, None] - cents[None], axis=2)
    own = d[np.arange(len(pts)), labels].mean()
    other = d[np.arange(classes)[None] != labels[:, None]].mean()
    return own / other


def test_tsne_on_the_card_separates_as_on_the_cpu(cuda_device):
    rng = np.random.default_rng(4)
    labels = rng.integers(0, 5, 200)
    x = torch.from_numpy((rng.normal(0, 1, (5, 512))[labels]
                          + rng.normal(0, 0.8, (200, 512))).astype(np.float32))
    card = tsne(x.to(cuda_device), seed=0)
    assert card.device.type == "cuda" and card.shape == (200, 2)
    card = card.cpu().numpy()
    cpu = tsne(x, seed=0).numpy()
    assert np.isfinite(card).all()
    assert _separation(card, labels, 5) < 0.5 and _separation(cpu, labels, 5) < 0.5


def test_int8_artifact_scores_match_the_cpu(cuda_device, no_tf32, tmp_path):
    from ssad_tpu_torch.serving.export import ServedScorer, export_checkpoint
    from ssad_tpu_torch.utils.ref_checkpoint import save_reference_checkpoint

    sd = init_model(build_model(ModelConfig(compute_dtype="float32")),
                    torch.Generator().manual_seed(1)).state_dict()
    bank = np.random.default_rng(1).standard_normal((40, 512)).astype(np.float32)
    ckpt = tmp_path / "bottle" / "best_model.ckpt"
    save_reference_checkpoint(ckpt, sd, bank, ModelConfig(compute_dtype="float32"))
    art = export_checkpoint(ckpt, tmp_path / "a.ssadpt", batch=4, imsize=(64, 64),
                            subject="bottle", device="cpu", dtype="int8")
    imgs = _images(6, 5, side=64)
    card = ServedScorer.from_file(art, device=cuda_device)(imgs)
    cpu = ServedScorer.from_file(art, device="cpu")(imgs)
    assert float(np.abs(card[0] - cpu[0]).max()) <= 1e-4
