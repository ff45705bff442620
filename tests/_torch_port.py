"""Shared helpers of the port's tests (tests/test_torch_*.py).

The JAX package runs on the CPU (tests/conftest.py forces it); the port
is driven with ``device="cpu"``.  Inputs are made from seeded numpy and
handed to both as numpy arrays.
"""

import numpy as np
import pytest
import torch


def jax_variables(state_dict, compute_dtype="float32"):
    """A reference-layout torch state dict → the JAX PeraNet's (model,
    params, batch_stats), cast against an ``eval_shape`` template (no
    compiled init)."""
    import jax
    import jax.numpy as jnp

    from ssad_tpu.config import ModelConfig
    from ssad_tpu.models.peranet import build_model
    from ssad_tpu.utils.ref_checkpoint import convert_peranet_state_dict
    from ssad_tpu.utils.torch_weights import _cast_like

    model = build_model(ModelConfig(compute_dtype=compute_dtype))
    tmpl = jax.eval_shape(
        lambda: model.init(jax.random.key(0), jnp.zeros((1, 64, 64, 3)), train=False)
    )
    raw_p, raw_s = convert_peranet_state_dict(
        {k: v.numpy() for k, v in state_dict.items() if "num_batches" not in k}
    )
    return (
        model,
        _cast_like(tmpl["params"], raw_p),
        _cast_like(tmpl["batch_stats"], raw_s),
    )


@pytest.fixture()
def cuda_device():
    """A test that needs the card takes this fixture; it skips where
    there is none (decided when the test runs, not at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: see README)")
    return torch.device("cuda")


def seeded(shape, seed, low=0.0, high=1.0):
    return np.random.default_rng(seed).uniform(low, high, shape).astype(np.float32)
