"""The JAX package's random stream rebuilt in numpy
(tests/_torch_jax_random.py) against ``jax.random``, flax's init
and the JAX trainer, on the CPU.

The key functions and the integer and uniform draws equal JAX's bit for
bit over 4,000 keys (uniform's ``u·(max − min) + min`` is one fused
multiply-add in XLA, emulated in f64); the truncated normal, whose
``erf``/``erf_inv`` come from scipy in f64 where XLA evaluates f32
polynomials, within 1e-6 relative of each value (measured: 3.4e-7 over
200,000 values).  The synthesizer's draws, the trainer's step keys and
batches, and the detector's permutation equal the JAX package's; the
initial weights equal ``init_model``'s within 1e-6 relative (measured:
each tensor within 2.4e-7 of its largest value).  Two planted faults,
the presampled coordinates' fold constant off by one and the validation
steps drawn before the train steps, must fail.
"""

import dataclasses
import functools

import _torch_jax_random as jr
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_card_fixtures import STREAM_DIGEST
from _torch_synth import jax_draws

from ssad_tpu.config import DataConfig as JDataConfig
from ssad_tpu.config import ModelConfig as JModelConfig
from ssad_tpu.config import OptimConfig as JOptimConfig
from ssad_tpu.config import TrainConfig as JTrainConfig
from ssad_tpu.data import mvtec as jmvtec
from ssad_tpu.models.peranet import build_model as jbuild_model
from ssad_tpu.models.peranet import init_model
from ssad_tpu.train import trainer as jtrainer
from ssad_tpu.train.memory_bank import init_bank
from ssad_tpu_torch.data.synthetic import SynthDraws, SynthSpec
from ssad_tpu_torch.utils.jax_bridge import state_dict_from_jax

N_KEYS = 4000
#: truncated_normal and the initial weights: relative to each value
TN_RTOL = 1e-6


@pytest.fixture(scope="module")
def keys():
    ks = jax.random.split(jax.random.key(20261018), N_KEYS)
    return ks, np.asarray(jax.random.key_data(ks))


def _vm(fn, ks):
    return np.asarray(jax.jit(jax.vmap(fn))(ks))


CASES = {
    "split": (lambda k: jax.random.key_data(jax.random.split(k, 5)),
              lambda kd: jr.split(kd, 5)),
    "fold_in": (lambda k: jax.random.key_data(jax.random.fold_in(k, 0x5A11)),
                lambda kd: jr.fold_in(kd, 0x5A11)),
    "random_bits": (lambda k: jax.random.bits(k, (3, 4)), lambda kd: jr.random_bits(kd, (3, 4))),
    "uniform": (lambda k: jnp.stack([jax.random.uniform(k, (7,)),
                                     jax.random.uniform(k, (7,), minval=-45.0, maxval=45.0),
                                     jax.random.uniform(k, (7,), minval=0.9, maxval=1.1)]),
                lambda kd: np.stack([jr.uniform(kd, (7,)), jr.uniform(kd, (7,), -45.0, 45.0),
                                     jr.uniform(kd, (7,), 0.9, 1.1)], axis=1)),
    "randint": (lambda k: jnp.stack([jax.random.randint(k, (5,), 0, 6),
                                     jax.random.randint(k, (5,), -5, 1000),
                                     jax.random.randint(k, (5,), 3, 3),
                                     jax.random.randint(k, (5,), 0, 2**31 - 1)]),
                lambda kd: np.stack([jr.randint(kd, (5,), 0, 6), jr.randint(kd, (5,), -5, 1000),
                                     jr.randint(kd, (5,), 3, 3),
                                     jr.randint(kd, (5,), 0, 2**31 - 1)], axis=1)),
    "bernoulli": (lambda k: jnp.stack([jax.random.bernoulli(k, 0.5, (4,)),
                                       jax.random.bernoulli(k, 0.3, (4,))]),
                  lambda kd: np.stack([jr.bernoulli(kd, 0.5, (4,)), jr.bernoulli(kd, 0.3, (4,))],
                                      axis=1)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_draws_bit_for_bit(keys, name):
    ks, kd = keys
    want_fn, got_fn = CASES[name]
    want, got = _vm(want_fn, ks), got_fn(kd)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want), f"{name}: {(got != want).sum()} values differ"


def test_key_bit_for_bit():
    for seed in (0, 1, 2, 12345, 2**31 - 1):
        assert np.array_equal(jr.key(seed), np.asarray(jax.random.key_data(jax.random.key(seed))))


@pytest.mark.parametrize("m", [5, 700, 2000])  # one sort round below 1626 rows, two above
def test_permutation_bit_for_bit(keys, m):
    ks, kd = keys
    n = N_KEYS if m < 1000 else 500
    want = _vm(lambda k: jax.random.permutation(k, m), ks[:n])
    got = np.stack([jr.permutation(kd[i], m) for i in range(n)])
    assert np.array_equal(got, want)
    assert torch.equal(jr.fit_permutation(3, m), torch.from_numpy(
        np.asarray(jax.random.permutation(jax.random.key(3), m)).astype(np.int64)))


def test_truncated_normal_within_tolerance(keys):
    ks, kd = keys
    want = _vm(lambda k: jax.random.truncated_normal(k, -2.0, 2.0, (50,)), ks)
    got = jr.truncated_normal(kd, -2, 2, (50,))
    assert got.dtype == np.float32 and (np.abs(got) < 2).all()
    np.testing.assert_allclose(got, want, rtol=TN_RTOL, atol=0)


def _equal_draws(a: SynthDraws, b: SynthDraws):
    return [f.name for f in dataclasses.fields(a) if f.name != "label_counts"
            and not torch.equal(getattr(a, f.name), getattr(b, f.name))]


SPECS = [("bottle", False), ("hazelnut", False), ("carpet", False), ("bottle", True)]


@functools.lru_cache(maxsize=None)
def _jax_synth_draws(subject: str, patch: bool):
    """(spec, 96 keys' data, the JAX engine's draws) at 256²: one compile
    per spec and process."""
    spec = SynthSpec(subject=subject, imsize=(256, 256), patch_localization=patch)
    ks = jax.random.split(jax.random.key(7), 96)
    return spec, np.asarray(jax.random.key_data(ks)), jax_draws(spec, ks, 15)


@pytest.mark.parametrize("subject,patch", SPECS, ids=[f"{s}-{'patch' if p else 'image'}"
                                                      for s, p in SPECS])
def test_jax_draws_np_equals_jax_draws(subject, patch):
    spec, kd, want = _jax_synth_draws(subject, patch)
    got = jr.jax_draws_np(spec, kd, 15)
    assert _equal_draws(got, want) == []
    assert got.label_counts == want.label_counts


def test_planted_fold_constant_fails(monkeypatch):
    spec, kd, want = _jax_synth_draws("bottle", False)
    monkeypatch.setattr(jr, "PRESAMPLE_FOLD", jr.PRESAMPLE_FOLD + 1)
    got = jr.jax_draws_np(spec, kd, 15)
    assert set(_equal_draws(got, want)) == {"coord_u", "scar_u", "walk_u"}


# --- the trainer's stream: every key a JAX Trainer.fit hands its steps --------

IMSIZE, BATCH, EPOCHS, MIN_LEN = 64, 8, (1, 2), 24


def _jax_fit_keys(tree, seed: int = 0, batch: int = BATCH, epochs=EPOCHS,
                  min_len: int = MIN_LEN):
    """A JAX ``Trainer.fit(seed)`` at 64² (batch 8, 1 + 2 epochs unless
    given) with its steps replaced by recorders (the stage loop, the key splits and the
    optimizer chain are the package's; nothing is compiled): the init key,
    and (kind, stage, key data) of every step in order, as
    tests/_torch_fit_hunt.py records them; with the JAX trainer and data."""
    data = jmvtec.prepare_pretext_data(str(tree), "bottle", imsize=(IMSIZE, IMSIZE),
                                       val_fraction=0.2, seed=seed)
    cfg = JTrainConfig(
        data=JDataConfig(dataset_dir=str(tree), subject="bottle", imsize=(IMSIZE, IMSIZE),
                         batch_size=batch, min_dataset_length=min_len),
        model=JModelConfig(compute_dtype="float32"),
        optim=JOptimConfig(projection_epochs=epochs[0], fine_tune_epochs=epochs[1]))
    jt = jtrainer.Trainer(cfg, data)
    record, init_keys = [], []
    shapes = jax.eval_shape(lambda k: init_model(jt.model, k), jax.random.key(0))[0]
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    get = jtrainer.Trainer._get_step_fns
    zero = {"loss": jnp.float32(0), "accuracy": jnp.float32(0)}

    def init_state(rng, stage):
        init_keys.append(np.asarray(jax.random.key_data(rng)))
        jt._params_template = template
        _, _, tx, _ = jt._get_step_fns(stage)
        m = cfg.model
        return jtrainer.TrainState(template, {}, tx.init(template),
                                   init_bank(m.memory_bank_size, m.latent_dim),
                                   jnp.zeros((), jnp.int32))

    def step_fns(stage):
        _, _, tx, steps = get(jt, stage)

        def tstep(state, key, *rest):
            record.append(("train", stage, np.asarray(jax.random.key_data(key))))
            return state, zero

        def estep(params, stats, key, *rest):
            record.append(("eval", stage, np.asarray(jax.random.key_data(key))))
            return zero

        return tstep, estep, tx, steps

    jt.init_state, jt._get_step_fns = init_state, step_fns
    jt.fit(seed=seed, verbose=False)
    return init_keys[0], record, jt, data


@pytest.fixture(scope="module")
def jax_fit(fake_mvtec):
    return _jax_fit_keys(fake_mvtec)


def _stream(data, cls=jr.JaxTrainStream, seed: int = 0):
    return cls(seed, data.train_images.shape[0], data.val_images.shape[0], BATCH, epochs=EPOCHS,
               min_len=MIN_LEN)


def test_train_stream_keys_equal_the_trainers(jax_fit):
    init_key, record, _, data = jax_fit
    stream = _stream(data)
    assert np.array_equal(jr.fold_in(jr.key(0), 0), init_key)
    got = [(s.kind, s.stage, s.key) for s in stream.keys()]
    assert len(got) == len(record) and {(k, s) for k, s, _ in got} == {
        (k, s) for k in ("train", "eval") for s in ("projection", "fine_tune")}
    for (kind, stage, k), (jkind, jstage, jk) in zip(got, record):
        assert (kind, stage) == (jkind, jstage) and np.array_equal(k, jk)


def test_train_stream_keys_at_the_parity_defaults(fake_mvtec):
    """The schedule at ``cli parity``'s settings, as the replay runs it
    (batch 96, 5 + 15 epochs, the default ``min_dataset_length`` and
    ``val_batches``): every key equal to a JAX ``Trainer.fit``'s."""
    defaults = JTrainConfig()
    min_len, val_batches = defaults.data.min_dataset_length, defaults.optim.val_batches
    init_key, record, _, data = _jax_fit_keys(fake_mvtec, seed=2, batch=96, epochs=(5, 15),
                                              min_len=min_len)
    stream = jr.JaxTrainStream(2, data.train_images.shape[0], data.val_images.shape[0], 96,
                               epochs=(5, 15), min_len=min_len, val_batches=val_batches)
    got = [(s.kind, s.stage, s.key) for s in stream.keys()]
    assert np.array_equal(jr.fold_in(jr.key(2), 0), init_key)
    assert len(got) == len(record) > 20 * 2
    for (kind, stage, k), (jkind, jstage, jk) in zip(got, record):
        assert (kind, stage) == (jkind, jstage) and np.array_equal(k, jk)


def test_train_stream_batches_equal_the_trainers(jax_fit):
    """A step key's indices and synthesizer keys, as ``_make_batch`` takes
    them, for a train and a validation step."""
    _, record, jt, data = jax_fit
    stream = _stream(data)
    steps = list(stream.keys())
    spec = SynthSpec(subject="bottle", imsize=(IMSIZE, IMSIZE))
    for i in (0, next(i for i, s in enumerate(steps) if s.kind == "eval")):
        seen = {}

        def synth(keys, imgs, *rest):
            seen["keys"], seen["imgs"] = np.asarray(jax.random.key_data(keys)), np.asarray(imgs)
            return imgs, jnp.zeros(imgs.shape[0], jnp.int32), imgs

        jt.synth = synth
        split = "train" if steps[i].kind == "train" else "val"
        jt._make_batch(jax.random.wrap_key_data(jnp.asarray(record[i][2])),
                       *jt._device_data(split))
        idx, draws = stream.batch_of(steps[i], spec, data.cut_pool.shape[0])
        images = data.train_images if split == "train" else data.val_images
        assert np.array_equal(np.asarray(images)[idx.numpy()], seen["imgs"])
        k_syn = jr.split(steps[i].key, 2)[1]
        assert np.array_equal(jr.split(k_syn, BATCH), seen["keys"])
        assert _equal_draws(draws, jr.jax_draws_np(spec, seen["keys"], data.cut_pool.shape[0])) \
            == []


def test_planted_val_first_fails(jax_fit):
    _, record, _, data = jax_fit

    class ValFirst(jr.JaxTrainStream):
        ORDER = ("eval", "train")

    got = list(_stream(data, ValFirst).keys())
    assert len(got) == len(record)
    assert not all(s.kind == r[0] and np.array_equal(s.key, r[2]) for s, r in zip(got, record))


def test_artificial_batches_equal_predict_artificials():
    """The JAX ``predict_artificial``'s indices and draws per batch
    (tests/_torch_eval.py reads them through JAX)."""
    from _torch_eval import jax_artificial_batches

    spec = SynthSpec(subject="hazelnut", imsize=(64, 64))
    want = list(jax_artificial_batches(spec, 10, 1, 40, 16, 3))
    got = list(jr.artificial_batches(spec, 10, 1, 40, 16, 3))
    assert len(got) == len(want) == 3
    for (gi, gd), (wi, wd) in zip(got, want):
        assert torch.equal(gi, wi) and _equal_draws(gd, wd) == []


def test_init_params_equal_init_model():
    """``init_params(0)`` against the JAX package's ``init_model`` with the
    key ``Trainer.fit(0)`` initialises with, at ResNet-18 width (the JAX
    init runs eagerly, ~15 s on one core: its ops compile one by one)."""
    params, stats = init_model(jbuild_model(JModelConfig()),
                               jax.random.fold_in(jax.random.key(0), 0), (1, 64, 64, 3))
    got_p, got_s = jr.init_params(0)
    flat = dict(jax.tree_util.tree_leaves_with_path(got_p))
    leaves = jax.tree_util.tree_leaves_with_path(params)
    assert len(flat) == len(leaves) == 78
    for path, want in leaves:
        want = np.asarray(want)
        got = flat[path]
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=TN_RTOL, atol=0, err_msg=str(path))
    assert jax.tree_util.tree_structure(got_s) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(np.asarray, stats))
    sd = state_dict_from_jax(got_p, got_s)
    from ssad_tpu_torch.config import ModelConfig
    from ssad_tpu_torch.models.peranet import build_model

    build_model(ModelConfig()).load_state_dict(sd, strict=True)


def test_stream_digest_is_pinned():
    assert jr.stream_digest() == STREAM_DIGEST
