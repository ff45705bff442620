"""The plain reference agrees with the port's CPU path at tiny sizes: the
PeraNet forward (f32, full images and 32×32 windows through the port's
folded stem), the windows, the k-NN scores, the fit's split and the
blur ⊗ upsample."""

import numpy as np
import pytest
import torch

from port_bench.core import seeded
from port_bench.reference import peranet as ref_net
from port_bench.reference import scoring as ref

CPU = torch.device("cpu")


def port_model(backbone, state):
    from ssad_tpu_torch.config import ModelConfig
    from ssad_tpu_torch.models.peranet import build_model

    net = build_model(ModelConfig(backbone=backbone, compute_dtype="float32"))
    net.load_state_dict(state, strict=True)
    return net.eval()


@pytest.mark.parametrize("backbone", ["resnet18", "wide_resnet50_2"])
@pytest.mark.parametrize("size", [32, 64])
def test_forward(backbone, size):
    from ssad_tpu_torch.evaluation.inference import InferenceEngine
    from ssad_tpu_torch.ops import image as im

    state = seeded.fill_state(ref_net.state_shapes(backbone), 5, CPU)
    x = im.normalize_imagenet(seeded.images(3, size, 5, "t", CPU))
    engine = InferenceEngine(port_model(backbone, state), CPU)
    if size == 32:  # the served path: the fused stem's plain version, then the trunk
        with torch.inference_mode():
            out = engine.patch_forward(x)
        logits, emb = out["classifier"], out["latent_space"]
    else:
        logits, emb = engine.predict_batch(x)
    r_logits, r_emb = ref_net.PeraNetReference(state, backbone).forward(x)
    assert torch.allclose(emb, r_emb, rtol=1e-4, atol=1e-4 * r_emb.abs().max())
    assert torch.allclose(logits, r_logits, rtol=1e-4, atol=1e-4 * r_logits.abs().max())


def test_windows():
    from ssad_tpu_torch.ops.patches import extract_patches

    x = torch.arange(2 * 48 * 48 * 3, dtype=torch.float32).reshape(2, 48, 48, 3)
    got = ref.windows(x, 32, 8)
    assert torch.equal(got, extract_patches(x, 32, 8).reshape(-1, 32, 32, 3))


def test_knn_and_split():
    from ssad_tpu_torch.models.detector import AnomalyDetector
    from ssad_tpu_torch.ops.knn import knn_cosine_scores_plain

    g = torch.Generator().manual_seed(3)
    normality = torch.randn(300, 64, generator=g)
    queries = torch.randn(40, 64, generator=g)
    det = AnomalyDetector(k=3).fit(normality, torch.Generator().manual_seed(11))
    bank, threshold = ref.fit(normality, 3, 11)
    assert torch.equal(bank, det.bank)
    assert threshold == pytest.approx(det.threshold, rel=1e-6)
    want = knn_cosine_scores_plain(queries, bank, k=3)
    assert torch.allclose(ref.knn_scores(queries, bank, 3), want, atol=1e-6)


@pytest.mark.parametrize("side, size", [(29, 256), (9, 96)])
def test_blur_upsample(side, size):
    from ssad_tpu_torch.ops.image import upsample_anomaly_maps

    maps = torch.from_numpy(np.random.default_rng(side).uniform(0, 0.3, (3, side, side)))
    got = ref.blur_upsample(maps.float(), size)
    assert torch.allclose(got, upsample_anomaly_maps(maps.float(), size), atol=2e-6)


def test_fp8_control_moves_the_forward():
    """The control's fp8 operands move the embedding far beyond the port's
    bf16 rounding on the same inputs."""
    state = seeded.fill_state(ref_net.state_shapes("resnet18"), 6, CPU)
    x = ref_net.normalize(seeded.images(4, 64, 6, "t", CPU))
    _, exact = ref_net.PeraNetReference(state).forward(x)
    _, fp8 = ref_net.PeraNetReference(state, precision=ref_net.Fp8()).forward(x)
    from ssad_tpu_torch.models.peranet import build_model
    from ssad_tpu_torch.config import ModelConfig

    net = build_model(ModelConfig(compute_dtype="bfloat16"))
    net.load_state_dict(state, strict=True)
    with torch.inference_mode():
        bf16 = net.eval()(x)["latent_space"]
    gap = lambda e: float((e - exact).abs().max() / exact.abs().max())  # noqa: E731
    assert gap(fp8) > 3 * gap(bf16)
