"""The bf16 model's modules in eval mode against the JAX package's, on the
CPU, as tests/test_torch_bf16_layers.py holds them in train mode (the
same harness, readings and limits: that file's docstring), with the
folded 4×4 stem added; and softmax cross-entropy on the bf16 model's
logits."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from _torch_bf16 import (BF, EVAL_CASES, all_readings, head_args, jax_module,
                         module_readings_within_limits)

from ssad_tpu.models.peranet import PeraNet as JPeraNet


@pytest.fixture(scope="module")
def readings():
    return all_readings(0, False)


@pytest.mark.parametrize("mode, case", [("eval", c) for c in EVAL_CASES])
def test_module_matches_jax(readings, mode, case):
    ok, r = module_readings_within_limits(readings, case)
    assert ok, r


def test_softmax_cross_entropy_on_bf16_model_logits():
    """optax's softmax cross-entropy and ``F.cross_entropy`` on the JAX
    bf16 model's logits: loss and ∂loss/∂logits within 1e-6 relative."""
    logits = jax_module(JPeraNet(compute_dtype=BF), head_args(0), True, 0,
                        method=JPeraNet.head)["out"]["classifier"]
    y = jnp.asarray([0, 0, 0, 0, 0, 1, 2, 3])

    def loss(z):
        return optax.softmax_cross_entropy_with_integer_labels(z, y).mean()

    j_loss, j_grad = loss(logits), np.asarray(jnp.asarray(jax.grad(loss)(logits)))
    z = torch.from_numpy(np.array(logits)).requires_grad_(True)
    p_loss = F.cross_entropy(z, torch.from_numpy(np.asarray(y, np.int64)))
    p_loss.backward()
    assert abs(float(p_loss.detach()) - float(j_loss)) <= 1e-6 * abs(float(j_loss))
    assert np.max(np.abs(z.grad.numpy() - j_grad)) <= 1e-6 * np.max(np.abs(j_grad))
