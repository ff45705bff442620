"""Training-mode BatchNorm of the port against ``flax.linen.BatchNorm`` (the
JAX package's layer: momentum 0.9, epsilon 1e-5), 2-D (N, C, H, W) and
1-D (N, C), f32 and bf16 input, on the same seeded numpy inputs, scale,
bias and running statistics.

Held: the output, the new running mean and variance (the BIASED batch
variance), and the gradients with respect to the input, scale and bias
against ``jax.grad`` of the same weighted sum.  Tolerances, relative to
the largest magnitude: f32 output and gradients 1e-6 (measured ≤ 2.3e-7);
bf16 output and input gradient 2⁻⁹, a quarter of a bf16 ulp at 1
(measured 0: the same bits), bf16 scale and bias gradients 1e-6
(measured ≤ 2.7e-7); running statistics 1e-6 absolute (measured ≤
1.2e-7).  A planted update with the unbiased variance (what
``F.batch_norm(training=True)`` does) moves the 1-D running variance by
9.8e-2 at batch 8 and must fail the 1e-6 limit.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssad_tpu_torch.models.resnet import BatchNorm1d, BatchNorm2d

torch.set_num_threads(1)

CASES = [  # (input shape in Flax's channels-last layout, dtype)
    ((4, 6, 5, 16), "float32"),
    ((4, 6, 5, 16), "bfloat16"),
    ((8, 32), "float32"),
    ((8, 32), "bfloat16"),
]
STATS_TOL = 1e-6


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    return {
        "x": rng.normal(0.3, 1.7, shape).astype(np.float32),
        "scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
        "bias": rng.normal(0, 0.2, c).astype(np.float32),
        "mean": rng.normal(0, 0.3, c).astype(np.float32),
        "var": rng.uniform(0.5, 2.0, c).astype(np.float32),
        "cotangent": rng.normal(0, 1, shape).astype(np.float32),
    }


def _flax(inp, dtype):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5, dtype=jdt)
    stats = {"mean": jnp.asarray(inp["mean"]), "var": jnp.asarray(inp["var"])}
    x = jnp.asarray(inp["x"]).astype(jdt)
    w = jnp.asarray(inp["cotangent"])

    def loss(x, scale, bias):
        y, upd = bn.apply({"params": {"scale": scale, "bias": bias}, "batch_stats": stats},
                          x, mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * w), (y, upd["batch_stats"])

    (_, (y, new)), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        x, jnp.asarray(inp["scale"]), jnp.asarray(inp["bias"]))
    to_np = lambda a: np.asarray(jnp.asarray(a, jnp.float32))  # noqa: E731
    return to_np(y), to_np(new["mean"]), to_np(new["var"]), [to_np(g) for g in grads]


def _port(inp, dtype, bn_cls=None):
    """The port's layer on the same values; returns what _flax returns, in
    channels-last layout."""
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    x_nhwc = torch.from_numpy(inp["x"])
    two_d = x_nhwc.ndim == 4
    c = x_nhwc.shape[-1]
    cls = bn_cls or (BatchNorm2d if two_d else BatchNorm1d)
    bn = cls(c, tdt).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(inp["scale"]))
        bn.bias.copy_(torch.from_numpy(inp["bias"]))
        bn.running_mean.copy_(torch.from_numpy(inp["mean"]))
        bn.running_var.copy_(torch.from_numpy(inp["var"]))
    x = (x_nhwc.permute(0, 3, 1, 2) if two_d else x_nhwc).to(tdt).contiguous()
    x.requires_grad_(True)
    y = bn(x)
    assert y.dtype == tdt
    w = torch.from_numpy(inp["cotangent"])
    w = w.permute(0, 3, 1, 2) if two_d else w
    (y.float() * w).sum().backward()

    def nhwc(t):
        t = t.detach().float()
        return (t.permute(0, 2, 3, 1) if two_d else t).numpy()

    return (nhwc(y), bn.running_mean.numpy(), bn.running_var.numpy(),
            [nhwc(x.grad), bn.weight.grad.numpy(), bn.bias.grad.numpy()])


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


@pytest.mark.parametrize("shape, dtype", CASES)
def test_train_mode_batchnorm_matches_flax(shape, dtype):
    inp = _inputs(shape)
    y_j, mean_j, var_j, grads_j = _flax(inp, dtype)
    y_p, mean_p, var_p, grads_p = _port(inp, dtype)
    tol = 2.0**-9 if dtype == "bfloat16" else 1e-6
    assert _rel(y_p, y_j) <= tol
    np.testing.assert_allclose(mean_p, mean_j, rtol=0, atol=STATS_TOL)
    np.testing.assert_allclose(var_p, var_j, rtol=0, atol=STATS_TOL)
    # the input gradient is rounded to the input's dtype; scale and bias
    # gradients are f32 sums over the batch
    assert _rel(grads_p[0], grads_j[0]) <= tol, "d/dx"
    for name, gp, gj in zip(("d/dscale", "d/dbias"), grads_p[1:], grads_j[1:]):
        assert _rel(gp, gj) <= 1e-6, name


def test_eval_mode_reads_the_running_statistics():
    inp = _inputs((8, 32))
    bn = BatchNorm1d(32).eval()
    with torch.no_grad():
        bn.running_mean.copy_(torch.from_numpy(inp["mean"]))
        bn.running_var.copy_(torch.from_numpy(inp["var"]))
    before = bn.running_var.clone()
    y = bn(torch.from_numpy(inp["x"]))
    ref = (inp["x"] - inp["mean"]) / np.sqrt(inp["var"] + 1e-5)
    np.testing.assert_allclose(y.detach().numpy(), ref, rtol=1e-5, atol=1e-5)
    assert torch.equal(bn.running_var, before)


class _UnbiasedUpdate(BatchNorm1d):
    """A planted fault: PyTorch's own running-variance update (unbiased)."""

    def forward(self, x):
        var = x.float().var(dim=0, unbiased=True).detach()
        y = super().forward(x)
        with torch.no_grad():
            self.running_var.sub_(0.1 * x.float().var(dim=0, unbiased=False)).add_(0.1 * var)
        return y


def test_a_planted_unbiased_variance_update_fails():
    inp = _inputs((8, 32))
    _, _, var_j, _ = _flax(inp, "float32")
    _, _, var_p, _ = _port(inp, "float32", _UnbiasedUpdate)
    assert np.max(np.abs(var_p - var_j)) > 100 * STATS_TOL
