"""Shared parts of the train-step parity tests
(tests/test_torch_train_step*.py): the configuration, seeded batches, the
JAX side (init + the jitted ``Trainer.train_step``) and the port's step.
The limits are ssad_tpu_torch/train/step_parity.py's ``CPU_LIMITS``; their
measured margins are in the docstring of test_torch_train_step.py."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from ssad_tpu.config import DataConfig as JDataConfig
from ssad_tpu.config import ModelConfig as JModelConfig
from ssad_tpu.config import OptimConfig as JOptimConfig
from ssad_tpu.config import TrainConfig as JTrainConfig
from ssad_tpu.models.peranet import init_model as jax_init_model
from ssad_tpu.train import trainer as jtrainer
from ssad_tpu.train.memory_bank import init_bank as jax_init_bank
from ssad_tpu_torch.config import DataConfig, ModelConfig, OptimConfig, TrainConfig
from ssad_tpu_torch.train.step_parity import CPU_LIMITS, GRAD_FLOOR
from ssad_tpu_torch.train.trainer import Trainer
from ssad_tpu_torch.utils.jax_bridge import (
    bank_from_numpy, load_optax_momentum, state_dict_from_jax,
)

torch.set_num_threads(1)

SIZE, BATCH, BANK = 64, 8, 6
LOSS_TOL, LOGIT_TOL, PARAM_TOL, GRAD_TOL, BANK_TOL = (
    CPU_LIMITS[k] for k in ("loss", "logits", "state", "grad_rel", "bank"))

_KW = dict(data=dict(imsize=(SIZE, SIZE), batch_size=BATCH, min_dataset_length=BATCH),
           model=dict(compute_dtype="float32", memory_bank_size=BANK),
           optim=dict(fine_tune_epochs=3))


def _jax_cfg(**model):
    return JTrainConfig(data=JDataConfig(**_KW["data"]),
                        model=JModelConfig(**_KW["model"], **model),
                        optim=JOptimConfig(**_KW["optim"]))


def port_cfg(**model):
    return TrainConfig(data=DataConfig(**_KW["data"]), model=ModelConfig(**_KW["model"], **model),
                       optim=OptimConfig(**_KW["optim"]))


#: what the trainers read of PretextData here: one epoch step of BATCH
_DATA = types.SimpleNamespace(train_images=np.zeros((BATCH, SIZE, SIZE, 3), np.float32),
                              cut_pool=np.zeros((1, SIZE, SIZE, 3), np.float32))


def seeded_batch(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (BATCH, SIZE, SIZE, 3)).astype(np.float32)
    y = np.array([0, 0, 0, 0, 0, 1, 2, 3], np.int64)
    orig = rng.uniform(0, 1, (BATCH, SIZE, SIZE, 3)).astype(np.float32)
    return x, y, orig


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def make_jax_side(init=None, **model):
    """The JAX init (or ``init``, another side's), and per stage the jitted
    step with the given batch; ``model``: ModelConfig fields to override."""
    jt = jtrainer.Trainer(_jax_cfg(**model), _DATA)
    if init is None:
        params, stats = jax.jit(lambda k: jax_init_model(jt.model, k, (1, SIZE, SIZE, 3)))(
            jax.random.key(0))
    else:
        params, stats = jax.tree.map(jnp.asarray, (init.params, init.stats))
    jt._params_template = params
    # the given batch rides in the step's data arguments: (images, masks,
    # coords) carry (x, y, originals)
    jt._make_batch = lambda key, x, y, orig, counts, pool: (x, y, orig)

    @jax.jit
    def loss_and_grads(params, stats, x, y):
        def loss_fn(p):
            out, _ = jt.model.apply({"params": p, "batch_stats": stats}, x, train=True,
                                    mutable=["batch_stats"])
            logits = out["classifier"]
            return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean(), logits

        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    def step(stage, state, batch):
        """(new JAX state, loss, logits, grads) of one step on ``batch``."""
        x, y, orig = (jnp.asarray(a) for a in batch)
        y = y.astype(jnp.int32)
        train_step, _, _, _ = jt._get_step_fns(stage)
        (_, logits), grads = loss_and_grads(state.params, state.batch_stats, x, y)
        dummy = jnp.zeros((1,), jnp.float32)
        new, metrics = train_step(state, jax.random.key(1), x, y, orig, dummy, dummy,
                                  jnp.asarray(True))
        return new, float(metrics["loss"]), np.asarray(logits), to_np(grads)

    def init_state(stage):
        """A fresh state of copies: the jitted step donates its input."""
        p, s = jax.tree.map(jnp.array, params), jax.tree.map(jnp.array, stats)
        _, _, tx, _ = jt._get_step_fns(stage)
        return jtrainer.TrainState(p, s, tx.init(p), jax_init_bank(BANK, 512),
                                   jnp.zeros((), jnp.int32))

    return types.SimpleNamespace(params=to_np(params), stats=to_np(stats), step=step,
                                 init_state=init_state)


def port_step(stage, params, stats, batch, optax_state=None, bank=None, **model):
    """The port's step from JAX variables → (trainer, metrics, state);
    ``model``: ModelConfig fields to override."""
    tr = Trainer(port_cfg(**model), _DATA, "cpu")
    tr.model.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    state = tr.make_state(stage)
    if optax_state is not None:
        load_optax_momentum(state.optimizer, tr.model, *optax_state)
    if bank is not None:
        state.bank = bank
    x, y, orig = (torch.from_numpy(a) for a in batch)
    tr.make_batch = lambda dd, idx, draws: (x, y, orig)
    state, metrics = tr.train_step(state, (None, None), None, fill=True)
    return tr, metrics, state


def max_abs(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


def check_step(tr, metrics, state, j_new, j_loss, j_logits, j_grads, stage):
    margins = {"loss": abs(float(metrics["loss"]) - j_loss),
               "logits": max_abs(metrics["logits"].numpy(), j_logits)}
    assert margins["loss"] <= LOSS_TOL and margins["logits"] <= LOGIT_TOL, margins
    # gradients of the trained parameters (the frozen backbone has none)
    g_ref = state_dict_from_jax(j_grads, None)
    worst_grad = 0.0
    for name, p in tr.model.named_parameters():
        if stage == "projection" and name.startswith("feature_extractor."):
            assert p.grad is None, name
            continue
        ref = g_ref[name].numpy()
        rel = max_abs(p.grad.numpy(), ref) / max(float(np.max(np.abs(ref))), GRAD_FLOOR)
        assert rel <= GRAD_TOL, (name, rel)
        worst_grad = max(worst_grad, rel)
    # the new parameters and BatchNorm statistics
    ref_sd = state_dict_from_jax(to_np(j_new.params), to_np(j_new.batch_stats))
    worst_param = 0.0
    for name, v in tr.model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        err = max_abs(v.numpy(), ref_sd[name].numpy())
        assert err <= PARAM_TOL, (name, err)
        worst_param = max(worst_param, err)
    # the bank after the fill
    assert int(state.bank.count) == int(j_new.bank.count) > 0
    assert int(state.bank.cursor) == int(j_new.bank.cursor)
    bank_err = max_abs(state.bank.data.numpy(), np.asarray(j_new.bank.data))
    assert bank_err <= BANK_TOL
    return {**margins, "grad_rel": worst_grad, "params": worst_param, "bank": bank_err}


