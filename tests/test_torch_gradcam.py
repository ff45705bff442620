"""Grad-CAM (models/gradcam.py) against the JAX package's
(ssad_tpu/models/gradcam.py): f32 weights carried by ``utils/jax_bridge``
(``_torch_port.jax_variables``), seeded 64² inputs, on the CPU.

Limit: 1e-4 absolute on maps in [0, 1] (measured at most 8.1e-6 over
these cases).  The maps are per-sample min-max normalised, so rounding
is amplified by 1/(hi − lo): here the saliency (2×2 at layer 4) spans
0.0197 or more before normalisation, or nothing at all (one sample whose
ReLU cuts every unit: its map is 0 in both packages).  A saliency ReLU
input within rounding of zero could take the other side in the other
package, as in the train-step tests; the closest one here is 2.0e-3 from
zero, far above rounding.  Zero maps fall exactly where the predicted
class is 'good'."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_eval import seeded_state_dict
from _torch_port import jax_variables

from ssad_tpu.models import gradcam as jg
from ssad_tpu_torch.config import ModelConfig
from ssad_tpu_torch.models import gradcam
from ssad_tpu_torch.models.peranet import build_model

torch.set_num_threads(1)
TOL = 1e-4


@pytest.fixture(scope="module")
def models():
    sd = seeded_state_dict(0)
    model = build_model(ModelConfig(compute_dtype="float32"))
    model.load_state_dict(sd)
    return model.eval(), jax_variables(sd, "float32")


def _inputs(seed, n=3, size=64):
    return np.random.default_rng(seed).normal(0, 1, (n, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("seed,class_idx", [(0, None), (1, None), (2, 1), (3, 3)])
def test_compute_gradcam_matches_jax(models, seed, class_idx):
    model, (jmodel, params, stats) = models
    x = _inputs(seed)
    got = gradcam.compute_gradcam(model, torch.from_numpy(x), class_idx).numpy()
    want = np.asarray(jg.compute_gradcam(jmodel, params, stats, jnp.asarray(x), class_idx))
    assert got.shape == want.shape == x.shape[:3]
    err = float(np.abs(got - want).max())
    print(f"seed {seed}: max |d| {err:.3g}")
    assert err <= TOL
    assert got.min() >= 0.0 and got.max() <= 1.0


def test_gradcam_or_zero_matches_jax(models):
    model, (jmodel, params, stats) = models
    x = _inputs(4, n=4)
    predicted = np.array([0, 2, 0, 3])
    got = gradcam.make_gradcam_fn(model)(torch.from_numpy(x), torch.from_numpy(predicted)).numpy()
    want = np.asarray(jg.make_gradcam_fn(jmodel, params, stats)(jnp.asarray(x), predicted))
    assert np.abs(got - want).max() <= TOL
    good = predicted == 0
    assert (got[good] == 0).all() and (got[~good].reshape(2, -1).max(1) == 1.0).all()


def test_gradcam_leaves_no_grad_and_runs_in_eval_mode(models):
    model, _ = models
    model.train()
    gradcam.compute_gradcam(model, torch.from_numpy(_inputs(5, n=2)))
    assert not model.training
    assert all(p.grad is None for p in model.parameters())
