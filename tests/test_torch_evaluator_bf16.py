"""``evaluate_category`` with bf16 compute (the product dtype) in both
packages, on fake_mvtec's bottle with the JAX fit permutation: the
numbers the parity tests hold in f32 (tests/test_torch_evaluator*.py),
read at bf16.  The two frameworks round their bf16 convolutions at
different places (embeddings differ by up to 1.9e-3,
tests/test_torch_models.py), so the metrics are held to 2e-3 (measured:
Grad-CAM pixel AUROC 8.2e-4, AUPRO 0; pixel AUROC 1.8e-4, IoU 1.8e-4,
AUPRO 6.1e-4; image AUROC and F1 equal)."""

import pytest
import torch
from _torch_eval import IMSIZE, seeded_state_dict, with_jax_draws
from _torch_port import jax_masks_on_the_numpy_path  # noqa: F401  (autouse fixture)
from _torch_port import jax_variables

from ssad_tpu.config import EvalConfig as JEvalConfig
from ssad_tpu.data import mvtec as jm
from ssad_tpu.evaluation import evaluator as jev
from ssad_tpu.evaluation import inference as jinf
from ssad_tpu_torch.config import EvalConfig, ModelConfig
from ssad_tpu_torch.data import mvtec as pm
from ssad_tpu_torch.evaluation import evaluator as ev
from ssad_tpu_torch.evaluation import inference as inf
from ssad_tpu_torch.models.peranet import build_model

torch.set_num_threads(1)
TOL = 2e-3
FIELDS = {False: ("image_auroc", "image_f1", "gradcam_pixel_auroc", "gradcam_aupro"),
          True: ("pixel_auroc", "iou", "aupro")}


@pytest.mark.parametrize("patch", [False, True])
def test_bf16_metrics_within_the_stated_reading(fake_mvtec, monkeypatch, patch):
    sd = seeded_state_dict(0)
    model = build_model(ModelConfig(compute_dtype="bfloat16"))
    model.load_state_dict(sd)
    jengine = jinf.InferenceEngine(*jax_variables(sd, "bfloat16"))
    size = (IMSIZE, IMSIZE)
    kw = dict(imsize=size, batch_size=8, patch_localization=patch, device_metrics=False)
    want = jev.evaluate_category(
        jengine, None, jm.prepare_pretext_data(fake_mvtec, "bottle", imsize=size),
        jm.prepare_mvtec_test_data(fake_mvtec, "bottle", imsize=size), JEvalConfig(**kw),
        "bottle", with_artificial=False)
    with_jax_draws(monkeypatch)
    got = ev.evaluate_category(
        inf.InferenceEngine(model, "cpu"), None,
        pm.prepare_pretext_data(fake_mvtec, "bottle", imsize=size),
        pm.prepare_mvtec_test_data(fake_mvtec, "bottle", imsize=size), EvalConfig(**kw),
        "bottle", with_artificial=False)
    for name in FIELDS[patch]:
        assert abs(getattr(got, name) - getattr(want, name)) <= TOL, name
