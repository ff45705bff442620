"""``evaluate_category`` with bf16 compute (the product dtype) in both
packages, on fake_mvtec's bottle with the JAX fit permutation: the
numbers the parity tests hold in f32 (tests/test_torch_evaluator*.py),
read at bf16.  The two frameworks round their bf16 convolutions at
different places (embeddings differ by up to 1.9e-3,
tests/test_torch_models.py), and where that rounding lands depends on the
CPU (oneDNN picks AMX, AVX-512 or AVX2 kernels; XLA its own order).

Held, with the spread measured over four CPU settings (default AMX-BF16,
``ONEDNN_MAX_CPU_ISA=AVX512_CORE``, ``ONEDNN_MAX_CPU_ISA=AVX2``,
``taskset -c 0``):

* the well-conditioned metrics within ``TOL`` = 2e-3: image AUROC and F1
  (equal), Grad-CAM AUPRO (equal), pixel AUROC (≤ 1.4e-4), AUPRO
  (≤ 4.8e-4);
* what they are computed from, elementwise: the image-level k-NN scores
  within ``SCORE_TOL`` (≤ 2.6e-5 measured) and the patch maps within
  ``MAP_TOL`` (≤ 1.8e-5 measured, on maps up to 2.8e-3);
* the Grad-CAM maps' form: zero where the classifier says 'good', each
  other map min-max normalised to [0, 1];
* the bf16 Grad-CAM itself, with its inputs pinned (``pinned_gradcam``,
  on each batch ``evaluate`` hands it): both packages start from the JAX
  backbone's bf16 layer-1..4 features, so what is compared is the
  gradient and the map, not the backbone's rounding.  The port's bf16
  ∂score/∂layer4 differs from the JAX ``jax.grad``'s in at most 1 % of
  its elements (measured 0.20–0.29 %: 16–24 of 8,192), by at most 2 bf16
  steps (measured 2); its maps within 1e-4 of JAX's (the f32 limit of
  tests/test_torch_gradcam.py; measured ≤ 4.9e-6), and within 1e-5 when
  made from the JAX gradients (measured 3.6e-7).  Planted faults
  (``PLANTS``, edits of the port's source): the gradient taken at an f32
  copy of layer 4 differs in every element and moves the maps 8.8e-4;
  the weighted sum in bf16 moves them 3.4e-3;
* the two ill-conditioned numbers, Grad-CAM pixel AUROC (near chance,
  0.44–0.50, |Δ| 3.5e-3 to 5.3e-2 across the settings) and IoU (at the
  optimal-F1 threshold, which jumps between runs of tied pixels: |Δ|
  2.7e-3 to 3.4e-3), as the JAX package's oracles compute them from the
  port's own maps: the same maps give the same number.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_eval import IMSIZE, seeded_state_dict, with_jax_draws
from _torch_port import jax_masks_on_the_numpy_path  # noqa: F401  (autouse fixture)
from _torch_port import jax_variables

from ssad_tpu.config import EvalConfig as JEvalConfig
from ssad_tpu.data import mvtec as jm
from ssad_tpu.evaluation import evaluator as jev
from ssad_tpu.evaluation import inference as jinf
from ssad_tpu.evaluation import metrics as JM
from ssad_tpu_torch.config import EvalConfig, ModelConfig
from ssad_tpu_torch.data import mvtec as pm
from ssad_tpu_torch.evaluation import evaluator as ev
from ssad_tpu_torch.evaluation import inference as inf
from ssad_tpu_torch.evaluation import metrics as PM
from ssad_tpu_torch.models.peranet import build_model

torch.set_num_threads(1)
TOL = 2e-3
SCORE_TOL = 5e-5
MAP_TOL = 4e-5
#: the pinned Grad-CAM's limits (module docstring)
PINNED_LIMITS = {"grads_unequal_share": 0.01, "grads_steps": 2.0,
                 "maps_own_grads": 1e-4, "maps_jax_grads": 1e-5}
FIELDS = {False: ("image_auroc", "image_f1", "gradcam_aupro"),
          True: ("pixel_auroc", "aupro")}


def pinned_gradcam(mp, model, jvars, x: torch.Tensor) -> dict:
    """Grad-CAM of the normalised batch ``x`` in both packages, the port
    handed the JAX backbone's bf16 features (``backbone_features``
    pinned): the port's own ∂score/∂layer4 against the JAX ``jax.grad``'s
    (how many differ, and by how many bf16 steps of the JAX value), the
    port's maps from its own gradients, and its maps made from the JAX
    gradients, each against the JAX maps."""
    import jax

    from ssad_tpu.models import gradcam as jg
    from ssad_tpu.models.peranet import PeraNet as JPeraNet
    from ssad_tpu_torch.models import gradcam as pg

    jmodel, params, stats = jvars
    jx = jnp.asarray(x.numpy())
    jpooled, jfeats = jmodel.apply({"params": params, "batch_stats": stats}, jx, train=False,
                                   method=JPeraNet.backbone_features)
    seen = []
    real_grad = jax.grad
    with mp.context() as m:
        m.setattr(jax, "grad", lambda f: lambda a: seen.append(real_grad(f)(a)) or seen[-1])
        want = np.asarray(jg.compute_gradcam(jmodel, params, stats, jx))

    def nchw(a):
        dtype = torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32
        return torch.from_numpy(np.array(a, np.float32)).to(dtype).permute(0, 3, 1, 2)

    feats = {k: nchw(v) for k, v in jfeats.items()}
    pooled = torch.from_numpy(np.array(jpooled, np.float32))
    jgrads = nchw(seen[0])
    mine, real_autograd = [], torch.autograd.grad
    with mp.context() as m:
        m.setattr(model, "backbone_features", lambda _: (pooled, feats))
        m.setattr(torch.autograd, "grad",
                  lambda *a, **k: mine.append(real_autograd(*a, **k)[0]) or (mine[-1],))
        own = pg.compute_gradcam(model, x).numpy()
        m.setattr(torch.autograd, "grad", lambda *a, **k: (jgrads.clone(),))
        from_jax = pg.compute_gradcam(model, x).numpy()
    (pgrads,) = mine
    j = jgrads.float()
    # one bf16 step at the JAX value: 2^(exponent − 7)
    step = torch.ldexp(torch.ones_like(j), torch.frexp(j).exponent - 8)
    return {"grads_unequal_share": float((pgrads.float() != j).float().mean()),
            "grads_steps": float(((pgrads.float() - j).abs() / step).max()),
            "maps_own_grads": float(np.abs(own - want).max()),
            "maps_jax_grads": float(np.abs(from_jax - want).max())}


def pinned_failures(reading: dict) -> list:
    """The limits of ``pinned_gradcam``'s reading that it breaks."""
    return [k for k, limit in PINNED_LIMITS.items() if not reading[k] <= limit]


def _spy(mp, module, name, record, pick):
    real = getattr(module, name)

    def spy(*args, **kw):
        out = real(*args, **kw)
        record.append(pick(args, out))
        return out

    mp.setattr(module, name, spy)


@pytest.mark.parametrize("patch", [False, True])
def test_bf16_metrics_within_the_stated_reading(fake_mvtec, monkeypatch, patch):
    sd = seeded_state_dict(0)
    model = build_model(ModelConfig(compute_dtype="bfloat16"))
    model.load_state_dict(sd)
    jengine = jinf.InferenceEngine(*jax_variables(sd, "bfloat16"))
    size = (IMSIZE, IMSIZE)
    kw = dict(imsize=size, batch_size=8, patch_localization=patch, device_metrics=False)
    maps, scores = {"jax": [], "port": []}, {"jax": [], "port": []}
    cam_inputs = []
    to_np = lambda t: t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)  # noqa: E731
    for who, metrics, infer in (("jax", JM, jinf), ("port", PM, inf)):
        _spy(monkeypatch, metrics, "compute_pro", maps[who],
             lambda a, _: np.array(a[0], np.float32))
        _spy(monkeypatch, infer, "attach_anomaly_scores", scores[who],
             lambda _, out: (to_np(out[0].anomaly_maps), to_np(out[0].y_hat)))
    want = jev.evaluate_category(
        jengine, None, jm.prepare_pretext_data(fake_mvtec, "bottle", imsize=size),
        jm.prepare_mvtec_test_data(fake_mvtec, "bottle", imsize=size), JEvalConfig(**kw),
        "bottle", with_artificial=False)
    with_jax_draws(monkeypatch)
    if not patch:
        from ssad_tpu_torch.models import gradcam as pg

        _spy(monkeypatch, pg, "compute_gradcam", cam_inputs, lambda a, _: a[1])
    got = ev.evaluate_category(
        inf.InferenceEngine(model, "cpu"), None,
        pm.prepare_pretext_data(fake_mvtec, "bottle", imsize=size),
        pm.prepare_mvtec_test_data(fake_mvtec, "bottle", imsize=size), EvalConfig(**kw),
        "bottle", with_artificial=False)
    for name in FIELDS[patch]:
        assert abs(getattr(got, name) - getattr(want, name)) <= TOL, name
    (jmaps,), (pmaps,) = maps["jax"], maps["port"]
    gts = np.asarray(pm.prepare_mvtec_test_data(fake_mvtec, "bottle", imsize=size).ground_truths)
    labels, flat = gts.ravel(), np.nan_to_num(pmaps.ravel())
    fpr, tpr, _ = JM.roc_curve(labels > 0, flat)
    if patch:
        assert np.abs(pmaps - jmaps).max() <= MAP_TOL
        thr = JM.optimal_f1_threshold(labels > 0, flat)
        assert abs(got.iou - JM.iou_score(labels, flat, thr)) <= 1e-12
        assert abs(got.pixel_auroc - JM.auc(fpr, tpr)) <= 1e-12
    else:
        (jscores, jyhat), (pscores, pyhat) = scores["jax"][0], scores["port"][0]
        assert np.abs(pscores - jscores).max() <= SCORE_TOL
        assert np.array_equal(pyhat, jyhat)
        good = pyhat == 0
        assert (pmaps[good] == 0).all() and pmaps.min() >= 0
        assert (pmaps[~good].reshape((~good).sum(), -1).max(axis=1) == 1).all()
        assert abs(got.gradcam_pixel_auroc - JM.auc(fpr, tpr)) <= 1e-12
        monkeypatch.undo()
        for x in cam_inputs:
            reading = pinned_gradcam(monkeypatch, model, jax_variables(sd, "bfloat16"), x)
            print("pinned Grad-CAM:", reading)
            assert pinned_failures(reading) == []


#: source edits of ssad_tpu_torch/models/gradcam.py::compute_gradcam
#: (old, new, the limits the edit must break)
PLANTS = {
    # the gradient taken at an f32 copy of layer 4: never rounded to bf16
    "f32_gradients": ('a4 = feats["layer4"].detach().requires_grad_(True)',
                      'a4 = feats["layer4"].detach().float().requires_grad_(True)',
                      {"grads_unequal_share", "maps_own_grads"}),
    # the weighted sum of layer 4 in bf16 instead of f32
    "bf16_saliency": ("(a4.float() * alpha[:, :, None, None]).sum(dim=1)",
                      "(a4 * alpha.to(a4.dtype)[:, :, None, None]).sum(dim=1).float()",
                      {"maps_own_grads", "maps_jax_grads"}),
}


@pytest.mark.parametrize("plant", sorted(PLANTS))
def test_a_planted_bf16_gradcam_fault_breaks_the_pinned_check(fake_mvtec, monkeypatch, plant):
    import inspect
    import textwrap

    from ssad_tpu_torch.models import gradcam as pg
    from ssad_tpu_torch.ops import image as im

    src = textwrap.dedent(inspect.getsource(pg.compute_gradcam))
    old, new, breaks = PLANTS[plant]
    assert src.count(old) == 1
    scope = dict(vars(pg))
    exec(src.replace(old, new), scope)
    sd = seeded_state_dict(0)
    model = build_model(ModelConfig(compute_dtype="bfloat16"))
    model.load_state_dict(sd)
    data = pm.prepare_mvtec_test_data(fake_mvtec, "bottle", imsize=(IMSIZE, IMSIZE))
    x = im.normalize_imagenet(torch.from_numpy(np.ascontiguousarray(data.images[:8])))
    assert pinned_failures(pinned_gradcam(monkeypatch, model, jax_variables(sd, "bfloat16"), x)) == []
    monkeypatch.setattr(pg, "compute_gradcam", scope["compute_gradcam"])
    reading = pinned_gradcam(monkeypatch, model, jax_variables(sd, "bfloat16"), x)
    print(plant, reading)
    assert breaks <= set(pinned_failures(reading))
