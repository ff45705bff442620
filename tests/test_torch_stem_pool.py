"""The fused stem in the port (ssad_tpu_torch/ops/stem_pool.py) against
the JAX package's ops/stem_pool.py and its PeraNet, on the same seeded
inputs.

* the fold and the BN affine: 1e-7 absolute + 1e-7 relative, one f32
  ulp (XLA's CPU divide/sqrt differ from IEEE in the last bit on ~0.5 %
  of values);
* ``stem_pool_plain`` vs ``stem_pool_xla`` and the Pallas kernel in
  interpret mode: f32 at rtol 1e-4 / atol 1e-5 (summation order); bf16 at
  rtol 2⁻⁷ / atol 1e-6 (one bf16 ulp), with fewer than 1e-3 of the
  elements not bit-equal: a sum near a rounding boundary may flip the
  last bit (the tolerance of tests/test_stem_pool.py:208-213);
* ``PeraNet.from_stem`` and the folded 32×32 module path vs JAX's: 1e-5
  (f32).
The CUDA kernel's own tests are in tests/test_torch_patch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import jax_variables, seeded
from test_ref_checkpoint import reference_state_dict

from ssad_tpu.ops import stem_pool as jsp
from ssad_tpu_torch.config import ModelConfig
from ssad_tpu_torch.models.peranet import build_model
from ssad_tpu_torch.ops import stem_pool

torch.set_num_threads(1)
BF16_RTOL, BF16_ATOL, MAX_FLIPPED = 2.0**-7, 1e-6, 1e-3


def _weights(seed=0):
    rng = np.random.default_rng(seed)
    k7 = rng.normal(0, 0.2, (7, 7, 3, 64)).astype(np.float32)
    s = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    b = rng.normal(0, 0.1, 64).astype(np.float32)
    return k7, s, b


def test_fold_and_bn_affine_match_jax():
    k7, s, b = _weights()
    rng = np.random.default_rng(1)
    mean = rng.normal(0, 0.1, 64).astype(np.float32)
    var = rng.uniform(0.5, 2.0, 64).astype(np.float32)
    np.testing.assert_allclose(
        stem_pool.fold_stem_kernel(torch.from_numpy(k7)).numpy(),
        np.asarray(jsp.fold_stem_kernel(jnp.asarray(k7))), atol=1e-7, rtol=0,
    )
    ours = stem_pool.bn_affine(*map(torch.from_numpy, (s, b, mean, var)))
    ref = jsp.bn_affine(*map(jnp.asarray, (s, b, mean, var)))
    for a, r in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-7, rtol=1e-7)


def test_folded_stem_affine_reads_the_state_dict_like_jax():
    sd = reference_state_dict(seed=2)
    _, params, stats = jax_variables(sd, "float32")
    ref = jsp.folded_stem_affine({"params": params, "batch_stats": stats})
    ours = stem_pool.folded_stem_affine(sd)
    for a, r in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-7, rtol=1e-7)


def _both(n, dtype, seed, interpret=False):
    k7, s, b = _weights(seed)
    k4 = np.asarray(jsp.fold_stem_kernel(jnp.asarray(k7)))
    x = seeded((n, 32, 32, 3), seed, -2.0, 2.0)
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jx = jnp.asarray(x).astype(jdtype)
    if interpret:
        from jax.experimental.pallas import tpu as pltpu

        with pltpu.force_tpu_interpret_mode():
            ref = jsp.stem_pool_pallas(jx, jnp.asarray(k4), jnp.asarray(s), jnp.asarray(b))
    else:
        ref = jsp.stem_pool_xla(jx, jnp.asarray(k4), jnp.asarray(s), jnp.asarray(b))
    xt = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(dtype)
    out = stem_pool.stem_pool(xt, torch.from_numpy(k4), torch.from_numpy(s), torch.from_numpy(b))
    return out.float().numpy(), np.asarray(ref.astype(jnp.float32))


@pytest.mark.parametrize("n", [4, 9])
def test_plain_matches_xla_in_float32(n):
    out, ref = _both(n, torch.float32, n)
    assert out.shape == (n, 16, 16, 64)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n, interpret", [(9, False), (4, False), (9, True)])
def test_plain_matches_jax_in_bfloat16(n, interpret):
    out, ref = _both(n, torch.bfloat16, 10 + n, interpret)
    np.testing.assert_allclose(out, ref, rtol=BF16_RTOL, atol=BF16_ATOL)
    assert np.count_nonzero(out != ref) / out.size < MAX_FLIPPED


def test_dispatch_refuses_other_devices_and_the_kernel_refuses_cpu():
    x = torch.zeros((2, 32, 32, 3), dtype=torch.bfloat16)
    k4, s, b = torch.zeros((4, 4, 3, 64)), torch.ones(64), torch.zeros(64)
    with pytest.raises(ValueError, match="CUDA"):
        stem_pool.stem_pool_cuda(x, k4, s, b)
    with pytest.raises(ValueError):
        stem_pool.stem_pool(x.to("meta"), k4, s, b)
    with pytest.raises(ValueError, match="32, 32, 3"):
        stem_pool.stem_pool(torch.zeros((2, 16, 16, 3)), k4, s, b)


def _models(sd):
    jmodel, params, stats = jax_variables(sd, "float32")
    model = build_model(ModelConfig(compute_dtype="float32"))
    model.load_state_dict(sd, strict=True)
    return jmodel, {"params": params, "batch_stats": stats}, model.eval()


def test_from_stem_matches_jax():
    sd = reference_state_dict(seed=3)
    jmodel, variables, model = _models(sd)
    x_stem = seeded((3, 16, 16, 64), 4)
    ref = jmodel.apply(variables, jnp.asarray(x_stem), train=False, method=type(jmodel).from_stem)
    with torch.inference_mode():
        out = model.from_stem(torch.from_numpy(x_stem))
    for key in ("classifier", "latent_space"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), rtol=1e-5, atol=1e-5)


def test_folded_module_path_matches_jax_backbone_features():
    sd = reference_state_dict(seed=5)
    jmodel, variables, model = _models(sd)
    x = seeded((3, 32, 32, 3), 6, -2.0, 2.0)
    jpooled, jfeats = jmodel.apply(
        variables, jnp.asarray(x), train=False, method=type(jmodel).backbone_features
    )
    with torch.inference_mode():
        pooled, feats = model.backbone_features(torch.from_numpy(x))
    np.testing.assert_allclose(pooled.numpy(), np.asarray(jpooled), rtol=1e-5, atol=1e-5)
    for tap in ("layer1", "layer2", "layer3", "layer4"):
        np.testing.assert_allclose(
            feats[tap].permute(0, 2, 3, 1).numpy(), np.asarray(jfeats[tap]),
            rtol=1e-5, atol=1e-5, err_msg=tap,
        )
    # the fused stem + from_stem is the same function as the module path
    k4, s, b = stem_pool.folded_stem_affine(sd)
    with torch.inference_mode():
        fused = model.from_stem(stem_pool.stem_pool(torch.from_numpy(x), k4, s, b))
        plain = model(torch.from_numpy(x))
    np.testing.assert_allclose(
        fused["latent_space"].numpy(), plain["latent_space"].numpy(), rtol=1e-4, atol=1e-4
    )
