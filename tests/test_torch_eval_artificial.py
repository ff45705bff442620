"""``predict_artificial`` (evaluation/inference.py) against the JAX
package's on the JAX package's draws: its key tree read into the port's
``SynthDraws`` by ``_torch_eval.jax_artificial_batches`` in place of
``inference.artificial_batches``, on fake_mvtec's
bottle and carpet (tests/conftest.py), f32 weights on both sides.

Held: labels and originals equal; every pixel of the synthesized batches
within 2⁻⁶ (two bf16 ulps at 1.0; measured at most 0.0095).  The
synthesizer tests' limit, ≥ 99.8 % of a sample's pixels within one ulp
(tests/_torch_synth.py), does not carry over: fake_mvtec's images are
nearly flat, so one rounding tie in the bf16 pipeline repeats over every
pixel of that value (worst sample 99.50 %), while a structural fault, a
defect drawn elsewhere or missing, moves pixels by far more than two
ulps.  The logits and embeddings equal the JAX model's on the port's own
batch within the f32 model's 1e-5 (tests/test_torch_models.py), and the
port's own draws are seeded.

The JAX package's object masks here are its OpenCV path's, which the
port computes bit for bit without OpenCV: these comparisons need
OpenCV on the machine that runs the tests (without it the JAX package
takes its numpy fallback, which the port does not compute)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_eval import IMSIZE, MODEL_TOL, jax_artificial_batches, jax_engine, seeded_state_dict

from ssad_tpu.config import AugConfig as JAugConfig
from ssad_tpu.data import mvtec as jm
from ssad_tpu.data.synthetic import SynthSpec as JSynthSpec
from ssad_tpu.evaluation import inference as jinf
from ssad_tpu.ops import image as jim
from ssad_tpu_torch.config import ModelConfig
from ssad_tpu_torch.data import mvtec as pm
from ssad_tpu_torch.data.synthetic import SynthSpec
from ssad_tpu_torch.evaluation import inference as inf
from ssad_tpu_torch.models.peranet import build_model
from ssad_tpu_torch.ops import image as im

PIXEL_TOL = 2.0**-6


@pytest.fixture(scope="module")
def engines():
    sd = seeded_state_dict(0)
    model = build_model(ModelConfig(compute_dtype="float32"))
    model.load_state_dict(sd)
    return inf.InferenceEngine(model, "cpu"), jax_engine(sd)


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=tol)


@pytest.mark.parametrize("subject", ["bottle", "carpet"])
def test_predict_artificial_on_the_jax_draws(engines, fake_mvtec, monkeypatch, subject):
    engine, jengine = engines
    data = pm.prepare_pretext_data(fake_mvtec, subject, imsize=(IMSIZE, IMSIZE))
    jdata = jm.prepare_pretext_data(fake_mvtec, subject, imsize=(IMSIZE, IMSIZE))
    spec = SynthSpec(subject=subject, imsize=(IMSIZE, IMSIZE))
    jspec = JSynthSpec(subject=subject, imsize=(IMSIZE, IMSIZE), aug=JAugConfig())
    n, bs = 40, 16  # a cut final batch
    monkeypatch.setattr(inf, "artificial_batches", jax_artificial_batches)
    out = inf.predict_artificial(engine, data, spec, num_samples=n, batch_size=bs,
                                 seed=3).to_host()
    want = jinf.predict_artificial(jengine, jdata, jspec, num_samples=n, batch_size=bs,
                                   seed=3).to_host()
    assert out.y_true_multiclass.shape == (n,)
    assert np.array_equal(out.y_true_multiclass, want.y_true_multiclass)
    assert np.array_equal(out.y_true_binary, want.y_true_binary)
    assert np.array_equal(out.original_data, want.original_data)
    x = im.denormalize_imagenet(torch.from_numpy(out.tensor_data)).numpy()
    jx = np.asarray(jim.denormalize_imagenet(jnp.asarray(want.tensor_data)))
    assert np.abs(x - jx).max() <= PIXEL_TOL
    # the model on the port's own batch
    jlogits, jemb = jengine.predict_batch(jnp.asarray(out.tensor_data))
    _close(out.raw_predictions, jlogits, MODEL_TOL)
    _close(out.embeddings, jemb, MODEL_TOL)
    assert np.array_equal(out.y_hat, np.asarray(jlogits).argmax(-1))


def test_own_draws_are_seeded(engines, fake_mvtec):
    engine, _ = engines
    data = pm.prepare_pretext_data(fake_mvtec, "carpet", imsize=(IMSIZE, IMSIZE))
    spec = SynthSpec(subject="carpet", imsize=(IMSIZE, IMSIZE))
    a = inf.predict_artificial(engine, data, spec, num_samples=6, batch_size=4, seed=1)
    b = inf.predict_artificial(engine, data, spec, num_samples=6, batch_size=4, seed=1)
    assert a.tensor_data.shape == (6, IMSIZE, IMSIZE, 3)
    assert torch.equal(a.tensor_data, b.tensor_data) and torch.equal(a.y_true_multiclass,
                                                                    b.y_true_multiclass)
