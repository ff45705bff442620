"""Shared parts of the train-step parity tests
(tests/test_torch_train_step*.py): the configuration, seeded batches, the
JAX side (init + the jitted ``Trainer.train_step``) and the port's step,
run under the JAX forward's ReLU and max-pool decisions (``Pinned``).
The limits are ssad_tpu_torch/train/step_parity.py's ``CPU_LIMITS``; their
measured margins, and the decision limits ``BAND_FACTOR`` and
``MAX_FLIPS``, are in the docstring of test_torch_train_step.py."""

import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

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

    @jax.jit
    def _intermediates(params, stats, x):
        _, st = jt.model.apply({"params": params, "batch_stats": stats}, x, train=True,
                               mutable=["batch_stats", "intermediates"],
                               capture_intermediates=True)
        return st["intermediates"]

    def decisions(params, stats, batch):
        """The train-mode forward's pre-activations on ``batch`` at
        ``params``/``stats`` (host trees) → ``Decisions``."""
        tree = _intermediates(*jax.tree.map(jnp.asarray, (params, stats)), jnp.asarray(batch[0]))
        return jax_decisions(to_np(tree))

    def init_state(stage):
        """A fresh state of copies: the jitted step donates its input."""
        p, s = jax.tree.map(jnp.array, params), jax.tree.map(jnp.array, stats)
        _, _, tx, _ = jt._get_step_fns(stage)
        return jtrainer.TrainState(p, s, tx.init(p), jax_init_bank(BANK, 512),
                                   jnp.zeros((), jnp.int32))

    return types.SimpleNamespace(params=to_np(params), stats=to_np(stats), step=step,
                                 init_state=init_state, decisions=decisions)


# --- the JAX forward's decisions, imposed on the port's step -----------------

#: a unit on which the two forwards disagree must lie within this many
#: times its layer's own spread of the boundary: the largest |port − JAX|
#: over the layer's units that agree (for a pooling window: the gap between
#: its two candidates against the largest |port − JAX| of the pool input)
BAND_FACTOR = 2.0
#: at most this many disagreeing units (ReLU inputs and max-pool windows)
MAX_FLIPS = 4


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def jax_decisions(inter):
    """The JAX PeraNet train forward's pre-activations, in the order the
    port's forward applies its ReLUs: the stem's BatchNorm, then per block
    bn1 and bn2 + shortcut (a basic block) or bn1, bn2 and bn3 + shortcut
    (a bottleneck block; the residual sum recomputed in f32 from the
    captured addends, which is the same IEEE add), then the latent MLP's
    BatchNorms; and the stem max-pool's input.  Any stage depths."""
    bb = inter["backbone"]
    stem = _nchw(bb["bn1"]["__call__"][0])
    relus = [("stem", stem)]
    prev = F.max_pool2d(F.relu(stem), 3, 2, 1)  # the max is exact
    for stage in range(1, 5):
        b = 0
        while f"layer{stage}_{b}" in bb:
            blk = bb[f"layer{stage}_{b}"]
            inner, last = (("bn1", "bn2"), "bn3") if "bn3" in blk else (("bn1",), "bn2")
            for bn in inner:
                relus.append((f"layer{stage}.{b}.{bn}", _nchw(blk[bn]["__call__"][0])))
            short = (_nchw(blk["downsample_bn"]["__call__"][0]) if "downsample_bn" in blk
                     else prev)
            relus.append((f"layer{stage}.{b}.sum", _nchw(blk[last]["__call__"][0]) + short))
            prev = _nchw(blk["__call__"][0])
            assert torch.equal(prev, F.relu(relus[-1][1])), relus[-1][0]
            b += 1
    i = 0
    while f"latent_{i}_bn" in inter:
        relus.append((f"latent.{i}", torch.tensor(np.asarray(inter[f"latent_{i}_bn"]["__call__"][0]))))
        i += 1
    return types.SimpleNamespace(relus=relus, pool_in=F.relu(stem))


def _ulp(scale):
    return 2.0 ** (np.floor(np.log2(scale)) - 23)


def _round_mantissa(x, bits=10):
    """``x`` rounded to ``bits`` mantissa bits (nearest, ties away), with
    the gradient of the identity: TF32's rounding of a conv input."""
    drop = 23 - bits
    i = x.detach().contiguous().view(torch.int32)
    r = ((i + (1 << (drop - 1))) & ~((1 << drop) - 1)).view(torch.float32)
    return x + (r - x.detach())


class Pinned(TorchFunctionMode):
    """The port's train forward under the JAX forward's decisions: the
    i-th ``F.relu`` passes exactly the units whose JAX pre-activation is
    > 0, and the stem's ``F.max_pool2d`` takes each window's value at the
    JAX input's argmax, so the backward routes every gradient term as the
    JAX backward does.  Each pinned call records the port's own input.
    Calls past the forward's (the bank fill's eval forward) run as they
    are.  ``round_conv_inputs``: a planted fault that rounds every
    ``F.conv2d`` input to 10 mantissa bits."""

    def __init__(self, decisions, round_conv_inputs=False):
        super().__init__()
        self.d, self.round = decisions, round_conv_inputs
        self.relus, self.pool = [], None

    def __torch_function__(self, func, types_, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is F.relu and len(self.relus) < len(self.d.relus):
            x = args[0]
            ref = self.d.relus[len(self.relus)][1]
            self.relus.append(x.detach().clone())
            return torch.where(ref > 0, x, torch.zeros_like(x))
        if func is F.max_pool2d and self.pool is None:
            x = args[0]
            _, idx = F.max_pool2d(self.d.pool_in, 3, 2, 1, return_indices=True)
            self.pool = (x.detach().clone(), idx)
            return x.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)
        if func is F.conv2d and self.round:
            args = (_round_mantissa(args[0]),) + tuple(args[1:])
        return func(*args, **kwargs)

    def report(self):
        """{flips: disagreeing units, band: the farthest one from the
        boundary in units of its layer's spread (BAND_FACTOR), worst_layer,
        spread_ulps: the largest layer spread in f32 ulps of that layer's
        scale (the largest |pre-activation|)}."""
        assert len(self.relus) == len(self.d.relus) and self.pool is not None
        flips, band, worst, spread_ulps = 0, 0.0, None, 0.0
        for (name, ref), got in zip(self.d.relus, self.relus):
            off = (got > 0) != (ref > 0)
            gap = float((got - ref).abs()[~off].max())
            spread_ulps = max(spread_ulps, gap / _ulp(float(ref.abs().max())))
            if off.any():
                flips += int(off.sum())
                far = float(torch.maximum(got[off].abs(), ref[off].abs()).max())
                if far / gap > band:
                    band, worst = far / gap, name
        x, idx = self.pool
        _, own = F.max_pool2d(x, 3, 2, 1, return_indices=True)
        off = own != idx
        if off.any():
            flips += int(off.sum())
            xf = x.flatten(2)
            tie = (xf.gather(2, own.flatten(2)) - xf.gather(2, idx.flatten(2))).view(idx.shape)
            ratio = float(tie[off].max()) / float((x - self.d.pool_in).abs().max())
            if ratio > band:
                band, worst = ratio, "maxpool"
        return {"flips": flips, "band": band, "worst_layer": worst, "spread_ulps": spread_ulps}


def port_step(stage, params, stats, batch, optax_state=None, bank=None, pin=None, **model):
    """The port's step from JAX variables → (trainer, metrics, state);
    ``pin``: a ``Pinned`` mode the step runs under; ``model``: ModelConfig
    fields to override."""
    tr = Trainer(port_cfg(**model), _DATA, "cpu")
    tr.model.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    state = tr.make_state(stage)
    if optax_state is not None:
        load_optax_momentum(state.optimizer, tr.model, *optax_state)
    if bank is not None:
        state.bank = bank
    x, y, orig = (torch.from_numpy(a) for a in batch)
    tr.make_batch = lambda dd, idx, draws: (x, y, orig)
    with pin if pin is not None else contextlib.nullcontext():
        state, metrics = tr.train_step(state, (None, None), None, fill=True)
    return tr, metrics, state


def max_abs(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


def step_margins(tr, metrics, state, j_new, j_loss, j_logits, j_grads, stage, pin=None):
    """The largest differences of the port's step from the JAX step's:
    loss, logits, gradients of the trained parameters relative to each
    tensor's scale, new parameters and BatchNorm statistics, the bank's
    rows (inf where its cursor or count differs); with ``pin``, its
    decision report too."""
    margins = {"loss": abs(float(metrics["loss"]) - j_loss),
               "logits": max_abs(metrics["logits"].numpy(), j_logits)}
    # gradients of the trained parameters (the frozen backbone has none)
    g_ref = state_dict_from_jax(j_grads, None)
    margins["grad_rel"], margins["grad_worst"] = 0.0, None
    for name, p in tr.model.named_parameters():
        if stage == "projection" and name.startswith("feature_extractor."):
            assert p.grad is None, name
            continue
        ref = g_ref[name].numpy()
        rel = max_abs(p.grad.numpy(), ref) / max(float(np.max(np.abs(ref))), GRAD_FLOOR)
        if rel > margins["grad_rel"]:
            margins["grad_rel"], margins["grad_worst"] = rel, name
    # the new parameters and BatchNorm statistics
    ref_sd = state_dict_from_jax(to_np(j_new.params), to_np(j_new.batch_stats))
    margins["params"] = max(max_abs(v.numpy(), ref_sd[name].numpy())
                            for name, v in tr.model.state_dict().items()
                            if not name.endswith("num_batches_tracked"))
    # the bank after the fill
    same = (int(state.bank.count) == int(j_new.bank.count)
            and int(state.bank.cursor) == int(j_new.bank.cursor))
    margins["bank"] = (max_abs(state.bank.data.numpy(), np.asarray(j_new.bank.data)) if same
                       else float("inf"))
    if pin is not None:
        margins.update(pin.report())
    return margins


#: the limits of ``beyond``: CPU_LIMITS and the decision limits
LIMITS = {"loss": LOSS_TOL, "logits": LOGIT_TOL, "grad_rel": GRAD_TOL, "params": PARAM_TOL,
          "bank": BANK_TOL, "flips": MAX_FLIPS, "band": BAND_FACTOR}


def beyond(margins, limits=None):
    """The keys of ``margins`` beyond their limits (``LIMITS`` unless given)."""
    return [k for k, tol in (limits or LIMITS).items() if k in margins and not margins[k] <= tol]


def check_step(tr, metrics, state, j_new, j_loss, j_logits, j_grads, stage, pin=None,
               limits=None):
    margins = step_margins(tr, metrics, state, j_new, j_loss, j_logits, j_grads, stage, pin)
    assert not beyond(margins, limits), margins
    assert int(j_new.bank.count) > 0
    return margins
