"""Shared parts of the train-step parity tests
(tests/test_torch_train_step*.py): the configuration, seeded batches, the
JAX side (init + the jitted ``Trainer.train_step``) and the port's step,
run under the JAX forward's ReLU and max-pool decisions (``Pinned``).
The limits are _torch_step_parity.py's ``CPU_LIMITS``; their
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
from _torch_pinning import Decisions, Pinned  # noqa: F401
from _torch_step_parity import CPU_LIMITS, GRAD_FLOOR  # noqa: F401

from ssad_tpu.config import DataConfig as JDataConfig
from ssad_tpu.config import ModelConfig as JModelConfig
from ssad_tpu.config import OptimConfig as JOptimConfig
from ssad_tpu.config import TrainConfig as JTrainConfig
from ssad_tpu.models.peranet import init_model as jax_init_model
from ssad_tpu.train import trainer as jtrainer
from ssad_tpu.train.memory_bank import init_bank as jax_init_bank
from ssad_tpu_torch.config import DataConfig, ModelConfig, OptimConfig, TrainConfig
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
                        model=JModelConfig(**{**_KW["model"], **model}),
                        optim=JOptimConfig(**_KW["optim"]))


def port_cfg(**model):
    return TrainConfig(data=DataConfig(**_KW["data"]), model=ModelConfig(**{**_KW["model"], **model}),
                       optim=OptimConfig(**_KW["optim"]))


#: XLA's ``xla_allow_excess_precision`` (on by default) lets a program keep
#: a value's f32 source where its source code rounds it to bf16 and a later
#: op reads it in f32; for the CPU that drops a bf16 convolution's rounding
#: before the BatchNorm.  Off, the program rounds every value its source
#: declares bf16, as op-by-op JAX does and the port does.
DECLARED_PRECISION = {"xla_allow_excess_precision": False}


def declared_jit(fn):
    """``fn`` (a ``jax.jit`` function) compiled with ``DECLARED_PRECISION``,
    once per signature of its arguments."""
    compiled = {}

    def call(*args):
        leaves, tree = jax.tree.flatten(args)
        key = (tree, tuple((jnp.shape(a), jnp.result_type(a)) for a in leaves))
        if key not in compiled:
            compiled[key] = fn.lower(*args).compile(compiler_options=DECLARED_PRECISION)
        return compiled[key](*args)

    return call


#: primitives a TPU runs at DEFAULT precision as one bf16 pass when an
#: operand is f32: both operands rounded to bf16, products summed in f32
_ONE_PASS = {jax.lax.dot_general_p, jax.lax.conv_general_dilated_p}
_CALLS = ("pjit", "jit", "closed_call", "core_call", "remat", "checkpoint",
          "custom_jvp_call", "custom_vjp_call")


def _default_precision(p) -> bool:
    default = (None, jax.lax.Precision.DEFAULT)
    return all(q in default for q in p) if isinstance(p, tuple) else p in default


def _eval_jaxpr(jaxpr, consts, *args):
    from jax.extend.core import Literal

    env = dict(zip(jaxpr.constvars, consts))
    env.update(zip(jaxpr.invars, args))

    def read(v):
        return v.val if isinstance(v, Literal) else env[v]

    for eqn in jaxpr.eqns:
        outs = _one_pass_eqn(eqn, [read(v) for v in eqn.invars])
        env.update(zip(eqn.outvars, outs if eqn.primitive.multiple_results else [outs]))
    return [read(v) for v in jaxpr.outvars]


def _as_fn(closed):
    jaxpr, consts = (closed.jaxpr, closed.consts) if hasattr(closed, "consts") else (closed, ())
    return lambda *a: _eval_jaxpr(jaxpr, consts, *a)


def _one_pass_eqn(eqn, vals):
    p, params = eqn.primitive, eqn.params
    if p in _ONE_PASS and _default_precision(params.get("precision")) and any(
            v.dtype == jnp.float32 for v in vals):
        vals = [v.astype(jnp.bfloat16) if v.dtype == jnp.float32 else v for v in vals]
        out = p.bind(*vals, **{**params, "preferred_element_type": jnp.float32})
        return out.astype(eqn.outvars[0].aval.dtype)
    if p.name in _CALLS:
        sub = params.get("jaxpr", params.get("call_jaxpr"))
        return _as_fn(sub)(*vals)
    if p.name == "cond":
        return jax.lax.switch(vals[0], [_as_fn(b) for b in params["branches"]], *vals[1:])
    if p.name == "while":
        cn, bn = params["cond_nconsts"], params["body_nconsts"]
        cc, bc, init = vals[:cn], vals[cn:cn + bn], vals[cn + bn:]
        cond, body = _as_fn(params["cond_jaxpr"]), _as_fn(params["body_jaxpr"])
        return jax.lax.while_loop(lambda c: cond(*cc, *c)[0], lambda c: body(*bc, *c), init)
    if p.name == "scan":
        nc, ncar = params["num_consts"], params["num_carry"]
        consts, carry, xs = vals[:nc], vals[nc:nc + ncar], vals[nc + ncar:]
        f = _as_fn(params["jaxpr"])

        def step(c, x):
            o = f(*consts, *c, *x)
            return o[:ncar], o[ncar:]

        c, ys = jax.lax.scan(step, carry, xs, length=params["length"],
                             reverse=params["reverse"], unroll=params["unroll"])
        return [*c, *ys]
    nested = {"jaxpr", "call_jaxpr", "branches"} & set(params)
    if nested and p.name not in ("reduce", "reduce_window"):
        raise NotImplementedError(f"tpu_one_pass: no rule for {p.name}")
    return p.bind(*vals, **params)


def tpu_one_pass(fn):
    """``fn`` (a JAX function) as a TPU computes it at DEFAULT precision:
    every dot and convolution with an f32 operand takes its operands
    rounded to bf16 and sums in f32 (the MXU's one pass), all else as
    written.  A jitted function of the same signature (it has ``lower``,
    so ``declared_jit`` composes with it); ``fn``'s program is traced and
    re-evaluated with those dots replaced, through calls, conds, loops
    and scans."""

    @jax.jit
    def run(*args):
        closed, shape = jax.make_jaxpr(fn, return_shape=True)(*args)
        out = _eval_jaxpr(closed.jaxpr, closed.consts, *jax.tree.leaves(args))
        return jax.tree.unflatten(jax.tree.structure(shape), out)

    return run


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


def make_jax_side(init=None, declared=True, **model):
    """The JAX init (or ``init``, another side's), and per stage the jitted
    step with the given batch; ``model``: ModelConfig fields to override.
    A bf16 side's programs are compiled with ``DECLARED_PRECISION`` unless
    ``declared`` is false (XLA's default)."""
    jt = jtrainer.Trainer(_jax_cfg(**model), _DATA)
    bf16 = model.get("compute_dtype") == "bfloat16"
    compile_ = declared_jit if bf16 and declared else (lambda f: f)
    if init is None:
        params, stats = jax.jit(lambda k: jax_init_model(jt.model, k, (1, SIZE, SIZE, 3)))(
            jax.random.key(0))
    else:
        params, stats = jax.tree.map(jnp.asarray, (init.params, init.stats))
    jt._params_template = params
    # the given batch rides in the step's data arguments: (images, masks,
    # coords) carry (x, y, originals)
    jt._make_batch = lambda key, x, y, orig, counts, pool: (x, y, orig)

    @compile_
    @jax.jit
    def loss_and_grads(params, stats, x, y):
        def loss_fn(p):
            out, _ = jt.model.apply({"params": p, "batch_stats": stats}, x, train=True,
                                    mutable=["batch_stats"])
            logits = out["classifier"]
            return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean(), logits

        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    steps = {}

    def step(stage, state, batch):
        """(new JAX state, loss, logits, grads) of one step on ``batch``."""
        x, y, orig = (jnp.asarray(a) for a in batch)
        y = y.astype(jnp.int32)
        train_step = steps.setdefault(stage, compile_(jt._get_step_fns(stage)[0]))
        (_, logits), grads = loss_and_grads(state.params, state.batch_stats, x, y)
        dummy = jnp.zeros((1,), jnp.float32)
        new, metrics = train_step(state, jax.random.key(1), x, y, orig, dummy, dummy,
                                  jnp.asarray(True))
        return new, float(metrics["loss"]), np.asarray(logits), to_np(grads)

    @compile_
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
    """A captured JAX map (NHWC, f32 or bf16) as an NCHW tensor of its
    dtype: bf16 is read through f32, which is exact."""
    if a.dtype == jnp.bfloat16:
        t = torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.permute(0, 3, 1, 2).contiguous()


def block_decisions(blk, prev, stage, b):
    """One captured JAX block's pre-activations in the port's ReLU order:
    bn1 (and bn2 in a bottleneck), then the last BatchNorm + shortcut
    recomputed as JAX adds them: in the compute dtype (in bf16 the f32
    sum of the two bf16 addends rounded once, as ``torch``'s bf16 add
    does), asserted to give the captured block output after the ReLU.
    ``prev``: the block's input (NCHW).  → (relus, its convolutions'
    outputs in the port's call order, block output)."""
    inner, last = (("bn1", "bn2"), "bn3") if "bn3" in blk else (("bn1",), "bn2")
    relus = [(f"layer{stage}.{b}.{bn}", _nchw(blk[bn]["__call__"][0])) for bn in inner]
    short = _nchw(blk["downsample_bn"]["__call__"][0]) if "downsample_bn" in blk else prev
    relus.append((f"layer{stage}.{b}.sum", _nchw(blk[last]["__call__"][0]) + short))
    out = _nchw(blk["__call__"][0])
    assert torch.equal(out, F.relu(relus[-1][1])), relus[-1][0]
    # a port block computes its shortcut first
    convs = [("downsample", "downsample_conv")] if "downsample_conv" in blk else []
    convs += [(c, c) for c in ("conv1", "conv2", "conv3") if c in blk]
    convs = [(f"layer{stage}.{b}.{n}", _nchw(blk[k]["__call__"][0])) for n, k in convs]
    return relus, convs, out


def jax_decisions(inter):
    """The JAX PeraNet train forward's pre-activations, in the order the
    port's forward applies its ReLUs: the stem's BatchNorm, then per block
    (``block_decisions``) bn1 and bn2 + shortcut (a basic block) or bn1,
    bn2 and bn3 + shortcut (a bottleneck block), then the latent MLP's
    BatchNorms; the stem max-pool's input; and every convolution's output
    in the port's call order (used by ``Pinned(teacher=True)``).  Any
    stage depths, f32 or bf16."""
    bb = inter["backbone"]
    stem = _nchw(bb["bn1"]["__call__"][0])
    relus, convs = [("stem", stem)], [("conv1", _nchw(bb["conv1"]["__call__"][0]))]
    prev = F.max_pool2d(F.relu(stem), 3, 2, 1)  # the max is exact
    for stage in range(1, 5):
        b = 0
        while f"layer{stage}_{b}" in bb:
            block, block_convs, prev = block_decisions(bb[f"layer{stage}_{b}"], prev, stage, b)
            relus += block
            convs += block_convs
            b += 1
    i = 0
    while f"latent_{i}_bn" in inter:
        relus.append((f"latent.{i}", torch.tensor(np.asarray(inter[f"latent_{i}_bn"]["__call__"][0]))))
        i += 1
    return Decisions(relus, F.relu(stem), convs)


def port_step(stage, params, stats, batch, optax_state=None, bank=None, pin=None, plant=None,
              **model):
    """The port's step from JAX variables → (trainer, metrics, state);
    ``pin``: a ``Pinned`` mode the step runs under; ``plant``: a context
    made from the trainer's model that it runs under; ``model``:
    ModelConfig fields to override."""
    tr = Trainer(port_cfg(**model), _DATA, "cpu")
    tr.model.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    state = tr.make_state(stage)
    if optax_state is not None:
        load_optax_momentum(state.optimizer, tr.model, *optax_state)
    if bank is not None:
        state.bank = bank
    x, y, orig = (torch.from_numpy(a) for a in batch)
    tr.make_batch = lambda dd, idx, draws: (x, y, orig)
    with plant(tr.model) if plant is not None else contextlib.nullcontext(), \
            pin if pin is not None else contextlib.nullcontext():
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
