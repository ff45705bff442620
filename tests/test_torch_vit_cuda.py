"""The transformer trunk (models/vit.py) on the card at its published widths
(DINOv2 ViT-g/14 with registers, 1.14 B parameters), against the plain
reference ``port_bench/reference/vit.py`` (f32, TF32 off) on the benchmark's
seeded weights and images.  Every test takes the ``cuda_device`` fixture,
carries the ``card`` marker and skips where there is no card.

Held, at 448² (the resampled position table) and 518² (the table's own
37 × 37 grid):
* float32 (TF32 off; the memory-efficient attention) within 1e-4 of the
  largest reference value: the same f32 operations, summed in other orders
  through 40 blocks;
* bfloat16 (FlashAttention-2) within 5e-2, the CPU test's bound for the
  same roundings;
* one bf16 forward runs the pinned attention kernel once a block, and no
  other attention kernel, so ``flash_fwd`` names it on the device trace.

This file imports neither JAX nor the JAX package:
    python -m pytest --noconftest tests/test_torch_vit_cuda.py
"""

import pytest
import torch
from _torch_port import cuda_device  # noqa: F401  (fixture)

from port_bench.core import seeded
from port_bench.reference import vit as ref_vit
from port_bench.reference.peranet import exact_f32, normalize
from ssad_tpu_torch.config import ModelConfig
from ssad_tpu_torch.models.peranet import build_model

BACKBONE = "dinov2_vitg14_reg"
SEED = 2**31 + 77
F32_TOL = 1e-4
BF16_TOL = 5e-2

pytestmark = pytest.mark.card


def rel(a, b):
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


@pytest.fixture(scope="module")
def state():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: see README)")
    return seeded.fill_state(ref_vit.state_shapes(BACKBONE), SEED, torch.device("cuda"))


def port(state, dtype):
    with torch.device("cuda"):
        model = build_model(ModelConfig(backbone=BACKBONE, compute_dtype=dtype))
    model.load_state_dict(state, strict=True)
    return model.eval()


@pytest.mark.parametrize("size", [448, 518])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_published_widths_match_the_reference(cuda_device, state, size, dtype):
    x = normalize(seeded.images(4, size, SEED, "requests", cuda_device))
    logits, emb = ref_vit.ViTPeraNetReference(state, BACKBONE).forward(x)
    model = port(state, dtype)
    with exact_f32(), torch.inference_mode():
        out = model(x)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    assert rel(out["classifier"], logits) < tol
    assert rel(out["latent_space"], emb) < tol
    del model
    torch.cuda.empty_cache()


def test_the_pinned_attention_kernel_runs_once_a_block(cuda_device, state):
    from torch.profiler import ProfilerActivity, profile

    model = port(state, "bfloat16")
    x = normalize(seeded.images(2, 448, SEED, "requests", cuda_device))
    with torch.inference_mode():
        model(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            model(x)
            torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("flash_fwd" in n for n in names) == 40
    assert not any("efficient_attention" in n or "fmha" in n for n in names)
