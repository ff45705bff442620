"""The scorers and the bottleneck backbones on the card: the coreset loop
with no host sync, Mahalanobis scores that do not read the TF32 flag,
and a bottleneck PeraNet's f32 windows against the CPU port.  Every test
here takes the ``cuda_device`` fixture and skips where there is no card.

This file imports neither JAX nor the JAX package, so it also runs on a
machine without them:  python -m pytest --noconftest tests/test_torch_scorers_cuda.py
Tolerances: each coreset pick within 1e-5 of the farthest distance in
float64; Mahalanobis 1e-6 relative to the CPU's (both float64, rounded
to f32 once); the f32 windows 1e-3, chip_smoke.py's
``PATCH_F32_MODEL_TOL`` (the stem rounds to bf16 and may flip a value by
one ulp on one side).
"""

import pytest
import torch
from _torch_port import cuda_device  # noqa: F401  (fixture)

from ssad_tpu_torch.config import ModelConfig
from ssad_tpu_torch.evaluation.inference import InferenceEngine
from ssad_tpu_torch.models.detector import MahalanobisDetector, mahalanobis_distances
from ssad_tpu_torch.models.peranet import build_model, init_model
from ssad_tpu_torch.ops.coreset import kcenter_greedy


def _rows(n, d, seed):
    return torch.randn((n, d), generator=torch.Generator().manual_seed(seed))


def test_kcenter_greedy_runs_without_a_host_sync(cuda_device):
    """No host sync in the k steps; each pick is a farthest row from the
    centers so far, checked in float64 on the host to 1e-5 (rows at a
    near tie may go either way on either device)."""
    x = _rows(3000, 512, 0)
    xd = x.to(cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = kcenter_greedy(xd, 256, first=11)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    got = got.cpu()
    assert torch.equal(got, kcenter_greedy(xd, 256, first=11).cpu())
    assert int(got[0]) == 11 and len(set(got.tolist())) == 256
    xn = x.double() / x.double().norm(dim=1, keepdim=True)
    min_d = torch.full((3000,), float("inf"), dtype=torch.float64)
    for i in range(1, 256):
        min_d = torch.minimum(min_d, 2.0 - 2.0 * (xn @ xn[got[i - 1]]))
        assert min_d[got[i]] >= min_d.max() - 1e-5, i


def test_mahalanobis_does_not_read_the_tf32_flag(cuda_device):
    emb, q = _rows(2000, 512, 1), _rows(6728, 512, 2)
    cpu = MahalanobisDetector().fit(emb, torch.Generator().manual_seed(0))
    want = mahalanobis_distances(q, cpu.mean, cpu.precision)
    flag = torch.backends.cuda.matmul.allow_tf32
    runs = []
    try:
        for tf32 in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            det = MahalanobisDetector().fit(emb.to(cuda_device), torch.Generator().manual_seed(0))
            runs.append((det.precision, det.predict(q.to(cuda_device))))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
    rel = ((runs[1][1].cpu() - want).abs() / want).max().item()
    assert rel <= 1e-6


@pytest.mark.parametrize("arch", ["resnet50", "wide_resnet50_2"])
def test_bottleneck_windows_f32_match_the_cpu(cuda_device, arch):
    model = init_model(build_model(ModelConfig(backbone=arch, compute_dtype="float32")),
                       torch.Generator().manual_seed(3))
    sd = model.state_dict()
    windows = (2 * torch.rand((8, 32, 32, 3), generator=torch.Generator().manual_seed(4))
               - 1).to(torch.bfloat16)
    flag = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        outs = []
        for dev in (cuda_device, torch.device("cpu")):
            m = build_model(ModelConfig(backbone=arch, compute_dtype="float32"))
            m.load_state_dict(sd, strict=True)
            with torch.inference_mode():
                outs.append(InferenceEngine(m, dev).patch_forward(windows.to(dev))
                            ["latent_space"].cpu())
    finally:
        torch.backends.cudnn.allow_tf32 = flag
    assert outs[0].shape == (8, 512) and torch.isfinite(outs[0]).all()
    assert (outs[0] - outs[1]).abs().max().item() <= 1e-3
