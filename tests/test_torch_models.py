"""The port's PeraNet against the JAX package's, through the weight bridge.

Seeded reference-layout weights (tests/test_ref_checkpoint.py) become
JAX variables; utils/jax_bridge.py carries them back into the port; both
run eval-mode forwards on the same seeded images.

Tolerances: f32 1e-5 (measured max 6.6e-7 on the embedding, summation
order only).  bf16 compute 5e-3 absolute (measured 1.9e-3 on embeddings
of magnitude ~1: the two frameworks round their bf16 convolutions at
different places, and one bf16 ulp at 1.0 is 7.8e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import jax_variables, seeded
from test_ref_checkpoint import lightning_checkpoint, reference_state_dict

from ssad_tpu.utils.ref_checkpoint import convert_peranet_state_dict
from ssad_tpu_torch.config import ModelConfig
from ssad_tpu_torch.models.peranet import build_model
from ssad_tpu_torch.ops.image import normalize_imagenet, resize_nearest
from ssad_tpu_torch.utils.jax_bridge import state_dict_from_jax

torch.set_num_threads(1)


def _both(compute_dtype, x):
    jmodel, params, stats = jax_variables(reference_state_dict(), compute_dtype)
    ref = jmodel.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train=False)
    sd = state_dict_from_jax(jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, stats))
    model = build_model(ModelConfig(compute_dtype=compute_dtype))
    model.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        out = model.eval()(torch.from_numpy(x))
    return ref, out


@pytest.mark.parametrize(
    "compute_dtype, tol", [("float32", 1e-5), ("bfloat16", 5e-3)]
)
def test_peranet_eval_matches_jax(compute_dtype, tol):
    x = seeded((2, 64, 64, 3), 3)
    ref, out = _both(compute_dtype, x)
    for key in ("classifier", "latent_space"):
        assert out[key].dtype == torch.float32
        np.testing.assert_allclose(
            out[key].numpy(), np.asarray(ref[key]), rtol=tol, atol=tol, err_msg=key
        )


def test_small_inputs_are_upsampled_like_jax():
    """32×32 inputs take the folded 4×4 stem in both packages: the nearest
    ×2 upsample folded into the weights."""
    ref, out = _both("float32", seeded((2, 32, 32, 3), 5))
    np.testing.assert_allclose(
        out["latent_space"].numpy(), np.asarray(ref["latent_space"]), rtol=1e-5, atol=1e-5
    )


def test_other_small_inputs_are_upsampled_like_jax():
    """Other sizes under 64 px are nearest-upsampled to 64 and take the
    7×7 stem in both packages."""
    ref, out = _both("float32", seeded((2, 48, 48, 3), 5))
    np.testing.assert_allclose(
        out["latent_space"].numpy(), np.asarray(ref["latent_space"]), rtol=1e-5, atol=1e-5
    )


def test_bridge_round_trip_is_exact():
    sd = reference_state_dict(seed=4)
    params, stats = convert_peranet_state_dict(
        {k: v.numpy() for k, v in sd.items() if "num_batches" not in k}
    )
    back = state_dict_from_jax(params, stats)
    assert set(back) == set(sd)
    for key, value in sd.items():
        assert torch.equal(back[key], value), key


def test_reference_lightning_checkpoint_loads_strict():
    model = build_model(ModelConfig())
    model.load_state_dict(lightning_checkpoint()["state_dict"], strict=True)


def test_image_ops_match_jax():
    from ssad_tpu.ops import image as jim

    img = seeded((20, 12, 3), 7)
    np.testing.assert_allclose(
        normalize_imagenet(torch.from_numpy(img)).numpy(),
        np.asarray(jim.normalize_imagenet(jnp.asarray(img))), atol=1e-6,
    )
    for size in ((40, 24), (64, 64), (13, 7)):  # integer factor, ragged, down
        np.testing.assert_array_equal(
            resize_nearest(torch.from_numpy(img), size).numpy(),
            np.asarray(jim.resize_nearest(jnp.asarray(img), size)),
        )
