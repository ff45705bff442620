"""The port's training optimiser and initialisation against the JAX
package's.

* The cosine lr equals ``cosine_warm_restarts`` at every step of 3
  epochs to 2.4e-7 relative (two f32 ulps: the JAX schedule is evaluated
  in f32, the port's in f64; measured 1.15e-7).
* Three SGD steps on a toy tree with given gradients equal optax's
  ``torch_sgd`` chain (decay → trace → lr) to 1e-6, at a constant lr
  and under the schedule; ``torch.optim.SGD``'s semantics are checked
  here, not assumed.
* The projection stage leaves the backbone's parameters bit-identical
  while its BatchNorm statistics move and the head is updated.
* ``init_model`` draws the JAX ``init_model``'s distribution: per tensor
  the std within 5 % of the JAX init's at the same shapes, the mean near
  0, every value inside the ±2 truncation of Lecun-normal; zero dense
  biases, unit BN scales, BN running mean 0 and variance 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ssad_tpu.config import ModelConfig as JaxModelConfig
from ssad_tpu.config import OptimConfig as JaxOptimConfig
from ssad_tpu.models.peranet import build_model as jax_build_model
from ssad_tpu.models.peranet import init_model as jax_init_model
from ssad_tpu.train import optim as joptim
from ssad_tpu_torch.config import ModelConfig, OptimConfig
from ssad_tpu_torch.models.peranet import build_model, init_model
from ssad_tpu_torch.train.optim import StageOptimizer, cosine_warm_restarts
from ssad_tpu_torch.utils.jax_bridge import state_dict_from_jax

torch.set_num_threads(1)


def test_cosine_schedule_matches_jax():
    base, t0, steps = 0.005, 3, 7
    ours = cosine_warm_restarts(base, t0, steps)
    theirs = joptim.cosine_warm_restarts(base, t0, steps)
    for step in range(3 * steps + 2):  # every step of 3 epochs and a restart
        np.testing.assert_allclose(ours(step), float(theirs(jnp.int32(step))), rtol=2.4e-7)


class _Toy(torch.nn.Module):
    def __init__(self, a, b):
        super().__init__()
        self.a = torch.nn.Parameter(torch.from_numpy(a.copy()))
        self.b = torch.nn.Parameter(torch.from_numpy(b.copy()))


@pytest.mark.parametrize("stage", ["projection", "fine_tune"])
def test_three_sgd_steps_match_optax(stage):
    """The port's optimizer (torch.optim.SGD underneath) against
    ``torch_sgd``; steps_per_epoch 1 so the fine-tune lr changes per step."""
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(4, 3)).astype(np.float32), rng.normal(size=5).astype(np.float32)
    cfg = OptimConfig(fine_tune_epochs=3)
    lr = (cfg.projection_lr if stage == "projection"
          else joptim.cosine_warm_restarts(cfg.fine_tune_lr, cfg.fine_tune_epochs, 1))
    tx = joptim.torch_sgd(lr, cfg.momentum, cfg.weight_decay)
    params = {"a": jnp.asarray(a), "b": jnp.asarray(b)}
    opt_state = tx.init(params)
    toy = _Toy(a, b)
    opt = StageOptimizer(toy, cfg, stage, steps_per_epoch=1)
    for _ in range(3):
        ga, gb = rng.normal(size=a.shape).astype(np.float32), rng.normal(size=b.shape).astype(np.float32)
        updates, opt_state = tx.update({"a": jnp.asarray(ga), "b": jnp.asarray(gb)}, opt_state,
                                       params)
        params = optax.apply_updates(params, updates)
        opt.zero_grad()
        toy.a.grad, toy.b.grad = torch.from_numpy(ga), torch.from_numpy(gb)
        opt.step()
        np.testing.assert_allclose(toy.a.detach().numpy(), np.asarray(params["a"]), atol=1e-6)
        np.testing.assert_allclose(toy.b.detach().numpy(), np.asarray(params["b"]), atol=1e-6)
    assert opt.count == 3


def _small_batch(seed=0):
    return torch.from_numpy(np.random.default_rng(seed).uniform(-1, 1, (4, 64, 64, 3))
                            .astype(np.float32))


def test_projection_freezes_the_backbone_but_updates_its_statistics():
    model = init_model(build_model(ModelConfig(compute_dtype="float32")),
                       torch.Generator().manual_seed(0)).train()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = StageOptimizer(model, OptimConfig(), "projection", steps_per_epoch=1)
    for _ in range(2):
        loss = model(_small_batch())["classifier"].logsumexp(-1).mean()
        opt.zero_grad()
        loss.backward()
        opt.step()
    after = model.state_dict()
    for name, p in model.named_parameters():
        if name.startswith("feature_extractor."):
            assert p.grad is None and not p.requires_grad, name
            assert torch.equal(after[name], before[name]), name
    assert not torch.equal(after["feature_extractor.bn1.running_mean"],
                           before["feature_extractor.bn1.running_mean"])
    assert not torch.equal(after["feature_extractor.layer4.1.bn2.running_var"],
                           before["feature_extractor.layer4.1.bn2.running_var"])
    for name in ("concatenator.0.weight", "latent_space.4.bias", "classifier.weight"):
        assert not torch.equal(after[name], before[name]), name
    # fine-tune trains every parameter again
    StageOptimizer(model, OptimConfig(), "fine_tune", steps_per_epoch=1)
    assert all(p.requires_grad for p in model.parameters())


@pytest.fixture(scope="module")
def both_inits():
    jmodel = jax_build_model(JaxModelConfig(compute_dtype="float32"))
    params, stats = jax.jit(lambda k: jax_init_model(jmodel, k))(jax.random.key(0))
    theirs = state_dict_from_jax(jax.tree.map(np.asarray, params),
                                 jax.tree.map(np.asarray, stats))
    ours = init_model(build_model(ModelConfig(compute_dtype="float32")),
                      torch.Generator().manual_seed(0)).state_dict()
    return ours, theirs


def test_init_distribution_matches_jax(both_inits):
    ours, theirs = both_inits
    assert set(ours) == set(theirs)
    for name, t in theirs.items():
        o = ours[name].float()
        assert o.shape == t.shape, name
        if name.endswith("num_batches_tracked"):
            continue
        if o.ndim >= 2:  # conv and dense weights: truncated Lecun-normal
            fan_in = o[0].numel()
            std = fan_in**-0.5
            assert abs(float(o.std()) / float(t.std()) - 1) < 0.05, name
            assert abs(float(o.mean())) < 0.1 * std, name
            bound = 2 * std / 0.87962566103423978
            assert float(o.abs().max()) <= bound * (1 + 1e-6), name
        else:  # biases, BN scale/bias, running statistics: constants
            assert torch.equal(o, t), name


def test_optim_config_defaults_match_jax():
    import dataclasses

    assert dataclasses.asdict(OptimConfig()) == dataclasses.asdict(JaxOptimConfig())
