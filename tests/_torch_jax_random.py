"""The JAX package's random stream in numpy: ``jax.random`` (threefry2x32
in its partitionable form, as JAX 0.9 draws with
``jax_threefry_partitionable=True``), flax's per-parameter init keys, and
the draws the JAX trainer and evaluator make from them.

So the port can train and evaluate on exactly the batches, synthesis draws
and initial weights a JAX run used, where no JAX is installed.  Nothing
here imports ``jax``, flax or the JAX package, and no module of the port
imports this one (it serves ``scripts/torch_parity_replay.py``,
``chip_smoke.py``'s stream digest and the tests).

A key is a uint32 array whose last axis holds its two words; every
function takes a batch of keys (``(..., 2)``) and draws for each.

* ``key``, ``split``, ``fold_in``, ``random_bits``: bit for bit
  (jax/_src/prng.py: ``threefry_seed``, ``_threefry_split_foldlike``,
  ``_threefry_fold_in``, ``_threefry_random_bits_partitionable``).
* ``uniform``, ``randint`` (two draws, modular), ``bernoulli``,
  ``permutation`` (rounds of a stable sort by random keys): bit for bit
  (jax/_src/random.py).
* ``truncated_normal``: the bounds' ``erf`` and the ``erf_inv`` come from
  scipy in float64 and are rounded to f32 once, where XLA evaluates f32
  polynomials, so a value may sit an f32 step or two from JAX's.
* ``init_params``: flax ``Module.init``'s key for each parameter is
  ``fold_in(root, sha1(path..., counter)[:4])`` (flax/core/scope.py
  ``LazyRng``, ``_fold_in_static``; flax 0.12 leaves
  ``flax_fix_rng_separator`` off, so no separator byte), and ``counter``
  counts the ``param`` calls of the module's scope: a kernel is its
  module's first.  Kernels are ``lecun_normal`` (truncated normal on
  (−2, 2) · √(1/fan_in) / 0.8796…), biases and BatchNorm shifts zeros,
  scales ones, running variances ones.
* ``jax_draws_np``: the JAX synthesizer's key tree per sample
  (ssad_tpu/data/synthetic.py ``make_synthesizer``: ``split(key, 8)`` and
  the branches' sub-splits; at image level the presampled coordinates'
  ``fold_in(key, 0x5A11)``, ``batched_synthesizer``) as the port's
  ``SynthDraws``.
* ``JaxTrainStream``: the JAX ``Trainer.fit`` schedule (stage keys folded
  from ``key(seed)``; one ``split`` of the stage key per train step, then
  per validation step; each step key → batch indices and draws), and the
  evaluation's artificial batches and fit permutation.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import re
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


# --- threefry2x32 and the keys ----------------------------------------------


def threefry2x32(k1, k2, x1, x2) -> Tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash (20 rounds) of counters (x1, x2) under the key
    (k1, k2); uint32 arrays, broadcast."""
    k1, k2, x1, x2 = (np.asarray(a, _U32) for a in (k1, k2, x1, x2))
    ks = (k1, k2, k1 ^ k2 ^ _U32(0x1BD11BDA))
    with np.errstate(over="ignore"):  # uint32 sums wrap, as in XLA
        x0, x1 = x1 + ks[0], x2 + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = x0 ^ ((x1 << _U32(r)) | (x1 >> _U32(32 - r)))
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + _U32(i + 1)
    return x0, x1


def key(seed: int) -> np.ndarray:
    """``jax.random.key(seed)``'s two words: the seed's high and low 32 bits."""
    seed = int(seed)
    if not 0 <= seed < 2**31:
        raise ValueError(f"seed {seed} outside [0, 2**31)")
    return np.array([0, seed], _U32)


def _iota(shape) -> Tuple[np.ndarray, np.ndarray]:
    """A 64-bit iota over ``shape`` as its (high, low) uint32 words."""
    n = math.prod(shape)
    if n >= 2**32:
        raise ValueError("more than 2**32 counters")
    return np.zeros(shape, _U32), np.arange(n, dtype=_U32).reshape(shape)


def _hash(keys, shape) -> Tuple[np.ndarray, np.ndarray]:
    """threefry of each key over an iota of ``shape`` → two (..., *shape)."""
    keys = np.asarray(keys, _U32)
    lead = keys.shape[:-1]
    hi, lo = _iota(tuple(shape))
    pad = (slice(None),) * len(lead) + (None,) * len(shape)
    return threefry2x32(keys[..., 0][pad], keys[..., 1][pad], hi, lo)


def split(keys, num: int = 2) -> np.ndarray:
    """``jax.random.split``: (..., 2) → (..., num, 2)."""
    b1, b2 = _hash(keys, (num,))
    return np.stack([b1, b2], axis=-1)


def fold_in(keys, data: int) -> np.ndarray:
    """``jax.random.fold_in`` of a uint32 ``data``: (..., 2) → (..., 2)."""
    keys = np.asarray(keys, _U32)
    b1, b2 = threefry2x32(keys[..., 0], keys[..., 1], 0, _U32(int(data) & 0xFFFFFFFF))
    return np.stack([b1, b2], axis=-1)


def random_bits(keys, shape=()) -> np.ndarray:
    """``jax.random.bits`` of 32 bits: (..., 2) → (..., *shape) uint32."""
    b1, b2 = _hash(keys, tuple(shape))
    return b1 ^ b2


# --- distributions ------------------------------------------------------------


def uniform(keys, shape=(), minval=0.0, maxval=1.0) -> np.ndarray:
    """``jax.random.uniform`` in f32: 23 random mantissa bits in [1, 2),
    less one, then ``max(minval, u·(maxval − minval) + minval)``."""
    bits = random_bits(keys, shape)
    floats = ((bits >> _U32(9)) | _U32(0x3F800000)).view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    # XLA contracts u·(maxval − minval) + minval into one fused multiply-add:
    # the f32 product is exact in f64, so one rounding of the f64 sum
    fma = floats.astype(np.float64) * np.float64(hi - lo) + np.float64(lo)
    return np.maximum(lo, fma.astype(np.float32))


def randint(keys, shape=(), minval=0, maxval=1) -> np.ndarray:
    """``jax.random.randint`` (int32): two 32-bit draws reduced modulo the
    span (jax/_src/random.py ``_randint``), in uint32 arithmetic."""
    ks = split(keys, 2)
    higher, lower = random_bits(ks[..., 0, :], shape), random_bits(ks[..., 1, :], shape)
    lo = np.asarray(minval, np.int64)
    hi = np.asarray(maxval, np.int64)
    span = np.asarray(np.where(hi <= lo, 1, (hi - lo) & 0xFFFFFFFF), _U32)
    with np.errstate(over="ignore"):  # uint32 arithmetic wraps, as in XLA
        multiplier = np.asarray(_U32(2**16) % span, _U32)
        multiplier = (multiplier * multiplier) % span
        offset = ((higher % span) * multiplier + (lower % span)) % span
    return (lo + offset.astype(np.int64)).astype(np.int32)


def bernoulli(keys, p: float = 0.5, shape=()) -> np.ndarray:
    """``jax.random.bernoulli`` (mode ``low``): uniform < p in f32."""
    return uniform(keys, shape) < np.float32(p)


def permutation(k, n: int) -> np.ndarray:
    """``jax.random.permutation(k, n)`` of one key: ⌈3·ln n / ln(2³²−1)⌉
    rounds, each a stable sort of the running order by fresh random bits."""
    x = np.arange(n, dtype=np.int32)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        k, sub = split(k, 2)
        x = x[np.argsort(random_bits(sub, (n,)), kind="stable")]
    return x


def truncated_normal(keys, lower: float, upper: float, shape=()) -> np.ndarray:
    """``jax.random.truncated_normal`` in f32: √2·erf⁻¹ of a uniform between
    erf(lower/√2) and erf(upper/√2), clipped inside (lower, upper)."""
    from scipy import special

    sqrt2 = np.float32(np.sqrt(2))
    lo, hi = np.float32(lower), np.float32(upper)
    a = np.float32(special.erf(np.float64(lo / sqrt2)))
    b = np.float32(special.erf(np.float64(hi / sqrt2)))
    u = uniform(keys, shape, a, b)
    out = sqrt2 * special.erfinv(u.astype(np.float64)).astype(np.float32)
    return np.clip(out, np.nextafter(lo, np.float32(np.inf)),
                   np.nextafter(hi, np.float32(-np.inf))).astype(np.float32)


# --- flax init ----------------------------------------------------------------

#: lecun_normal's divisor: the standard deviation of a standard normal
#: truncated to (−2, 2) (jax.nn.initializers.variance_scaling)
_TRUNC_STD = np.float32(0.87962566103423978)


def param_key(root, path, counter: int = 1) -> np.ndarray:
    """The key flax's ``init`` hands the ``counter``-th parameter of the
    module at ``path`` (its scope names from the root): one ``fold_in`` of
    the first four bytes of SHA-1 over the names and the counter."""
    m = hashlib.sha1()
    for x in (*path, counter):
        m.update(x.encode("utf-8") if isinstance(x, str)
                 else x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
    return fold_in(root, int.from_bytes(m.digest()[:4], byteorder="big"))


def lecun_normal(k, shape) -> np.ndarray:
    """flax's default kernel init for a (…, fan_in, out) kernel."""
    fan_in = math.prod(shape[:-1])
    std = np.sqrt(np.float32(1.0 / fan_in)).astype(np.float32) / _TRUNC_STD
    return (truncated_normal(k, -2, 2, shape) * std).astype(np.float32)


def _jax_path(name: str, n_latent: int) -> Tuple[Tuple[str, ...], str]:
    """A reference-layout state-dict entry → (JAX module path, leaf): the
    inverse of ``utils.jax_bridge.state_dict_from_jax``'s naming."""
    module, leaf = name.rsplit(".", 1)
    m = re.fullmatch(r"feature_extractor\.(conv1|bn1)", module)
    if m:
        path = ("backbone", m.group(1))
    elif module.startswith("feature_extractor.layer"):
        stage, block, *rest = module[len("feature_extractor.layer"):].split(".")
        sub = ".".join(rest)
        sub = {"downsample.0": "downsample_conv", "downsample.1": "downsample_bn"}.get(sub, sub)
        path = ("backbone", f"layer{stage}_{block}", sub)
    elif module in ("concatenator.0", "concatenator.1"):
        path = ("concatenator_dense" if module.endswith("0") else "concatenator_bn",)
    elif module == "classifier":
        path = ("classifier",)
    else:
        parts = module.split(".")  # latent_space.{i}[.{0,1}]
        i = int(parts[1])
        if len(parts) == 3:
            path = (f"latent_{i}_{'dense' if parts[2] == '0' else 'bn'}",)
        else:
            path = ("latent_out_dense" if i == n_latent else "latent_out_bn",)
    return path, leaf


def init_params(seed: int, model_cfg=None) -> Tuple[Dict, Dict]:
    """The JAX package's initial PeraNet variables as nested dicts of numpy
    (``params``, ``batch_stats``), in its layout: ``init_model(model, k)``
    with ``k = fold_in(key(seed), 0)``, the key ``Trainer.fit(seed)``
    initialises with.  ``utils.jax_bridge.state_dict_from_jax`` maps them
    to the port's."""
    from ssad_tpu_torch.config import ModelConfig
    from ssad_tpu_torch.models.peranet import build_model

    root = fold_in(key(seed), 0)
    cfg = model_cfg or ModelConfig()
    sd = build_model(cfg).state_dict()
    n_latent = max(cfg.latent_space_layers - 2, 0)
    params: Dict = {}
    stats: Dict = {}

    def put(tree, path, leaf, value):
        for p in path:
            tree = tree.setdefault(p, {})
        tree[leaf] = value

    for name, t in sd.items():
        if name.endswith("num_batches_tracked"):
            continue
        path, leaf = _jax_path(name, n_latent)
        shape = tuple(t.shape)
        if leaf == "weight" and len(shape) == 4:  # conv (O, I, kh, kw) → HWIO
            hwio = (shape[2], shape[3], shape[1], shape[0])
            put(params, path, "kernel", lecun_normal(param_key(root, path), hwio))
        elif leaf == "weight" and len(shape) == 2:  # dense (O, I) → (I, O)
            put(params, path, "kernel", lecun_normal(param_key(root, path), shape[::-1]))
        elif leaf == "weight":  # BatchNorm scale
            put(params, path, "scale", np.ones(shape, np.float32))
        elif leaf == "bias":
            put(params, path, "bias", np.zeros(shape, np.float32))
        elif leaf == "running_mean":
            put(stats, path, "mean", np.zeros(shape, np.float32))
        elif leaf == "running_var":
            put(stats, path, "var", np.ones(shape, np.float32))
        else:
            raise KeyError(name)
    return params, stats


# --- the synthesizer's draws --------------------------------------------------

#: the image-level presampled coordinates' fold (``batched_synthesizer``)
PRESAMPLE_FOLD = 0x5A11


def _randint_incl(keys, lo, hi) -> np.ndarray:
    """ssad_tpu/data/synthetic.py ``_randint_incl``: lo + ⌊u·(hi − lo + 1)⌋
    in f32, inclusive bounds."""
    lo = np.asarray(lo, np.int32)
    hi = np.maximum(np.asarray(hi, np.int32), lo)
    u = uniform(keys)
    return lo + np.floor(u * (hi - lo + 1).astype(np.float32)).astype(np.int32)


def _crop_geometry(keys, area_ratio, aspect_ratio, cut_hw):
    """``_gen_crop_geometry``: (pw, ph, src_left, src_top)."""
    k = split(keys, 6)
    cut_h, cut_w = cut_hw
    area = uniform(k[:, 0], (), *area_ratio) * np.float32(cut_h * cut_w)
    a1 = uniform(k[:, 2], (), *aspect_ratio[0])
    a2 = uniform(k[:, 3], (), *aspect_ratio[1])
    aspect = np.where(bernoulli(k[:, 1]), a1, a2)
    pw = np.maximum(np.sqrt(area * aspect).astype(np.int32), 2)
    ph = np.maximum(np.sqrt(area / aspect).astype(np.int32), 2)
    left = _randint_incl(k[:, 4], 0, np.maximum(cut_w - pw, 1))
    top = _randint_incl(k[:, 5], 0, np.maximum(cut_h - ph, 1))
    return pw, ph, left, top


def _colorize(keys, probs):
    k = split(keys, 4)
    u = uniform(k[:, 0])
    mode = np.where(u < np.float32(probs[0]), 0,
                    np.where(u < np.float32(probs[0] + probs[1]), 1, 2))
    rgb = np.stack([_randint_incl(k[:, i], 0, 255) for i in (1, 2, 3)], axis=-1)
    return mode, rgb


def _brightness(keys, aug):
    k = split(keys, 4)
    low = uniform(k[:, 0], (), *aug.brightness_low)
    high = uniform(k[:, 1], (), *aug.brightness_high)
    f1 = np.where(bernoulli(k[:, 2]), low, high)
    f2 = np.where(bernoulli(k[:, 3]), low, high)
    return (f1 * f2).astype(np.float32)


def _polygon(keys, pw, ph):
    """``_polygon_vertices``: ((n, 8, 2) vertices, (n,) count)."""
    k = split(keys, 13)
    w, h = pw.astype(np.int32), ph.astype(np.int32)
    hw, hh = w // 2, h // 2
    two = bernoulli(k[:, 0], 0.5, (4,))
    f = lambda v: np.asarray(v, np.float32)  # noqa: E731
    zero = np.zeros_like(f(w))
    ri = lambda i, lo, hi: f(_randint_incl(k[:, i], lo, hi))  # noqa: E731
    singles = [(zero, ri(1, 1, h)), (ri(4, 1, w), zero), (f(w), ri(7, 1, h)), (ri(10, 1, w), f(h))]
    firsts = [(zero, ri(2, hh + 1, h)), (ri(5, 1, hw), zero), (f(w), ri(8, 1, hh)),
              (ri(11, hw + 1, w), f(h))]
    seconds = [(zero, ri(3, 1, hh)), (ri(6, hw + 1, w), zero), (f(w), ri(9, hh + 1, h)),
               (ri(12, 1, hw), f(h))]
    n = keys.shape[0]
    verts = np.zeros((n, 8, 2), np.float32)
    row = np.arange(8)[None, :]
    off = np.zeros((n,), np.int32)
    for side in range(4):
        t = two[:, side]
        p1 = np.stack([np.where(t, firsts[side][j], singles[side][j]) for j in (0, 1)], -1)
        p2 = np.stack(seconds[side], -1)
        verts = np.where((row == off[:, None])[..., None], p1[:, None, :], verts)
        verts = np.where(((row == off[:, None] + 1) & t[:, None])[..., None], p2[:, None, :],
                         verts)
        off = off + 1 + t.astype(np.int32)
    return verts, off


def jax_draws_np(spec, keys, n_cut: int):
    """The draws the JAX synthesizer makes from ``keys`` ((n, 2), one per
    sample) for the port's ``SynthSpec`` ``spec``, as the port's
    ``SynthDraws`` on the CPU (tests/_torch_synth.py ``jax_draws`` reads
    the same tree through JAX)."""
    from ssad_tpu_torch.data.synthetic import SynthDraws

    keys = np.asarray(keys, _U32).reshape(-1, 2)
    n = keys.shape[0]
    aug = spec.aug
    patch = spec.patch_localization
    h, w = spec.imsize
    p = spec.patch_size
    ch, cw = spec.precrop_hw
    n_walk, max_copies = spec.line_points, spec.max_copies
    k = split(keys, 8)
    d = {"label": _randint_incl(k[:, 0], 0, 3)}
    ka = split(k[:, 1], 2)
    d["affine_angle"] = uniform(ka[:, 0], (), -aug.affine_degrees, aug.affine_degrees)
    d["affine_scale"] = uniform(ka[:, 1], (), *aug.affine_scale)
    d["cut_index"] = _randint_incl(k[:, 2], 0, max(n_cut - 1, 0))
    if patch:
        kx = split(k[:, 3], 3)
        kc = split(kx[:, 2], 2)
        d["crop_left"] = _randint_incl(kx[:, 0], 0, cw - p)
        d["crop_top"] = _randint_incl(kx[:, 1], 0, ch - p)
        d["cut_left"] = _randint_incl(kc[:, 0], 0, w - p)
        d["cut_top"] = _randint_incl(kc[:, 1], 0, h - p)
    else:
        for name in ("crop_left", "crop_top", "cut_left", "cut_top"):
            d[name] = np.zeros((n,), np.int32)

    # label 1 (_paste_polygon_patch): geo, colour, brightness, coordinate, polygon
    k1 = split(k[:, 4], 5)
    poly_geo = _crop_geometry(k1[:, 0], spec.patch_area_ratio, aug.patch_aspect_ratio,
                              spec.canvas)
    poly_col = _colorize(k1[:, 1], aug.color_probs)
    poly_bri = _brightness(k1[:, 2], aug)
    d["poly_vertices"], d["poly_count"] = _polygon(k1[:, 4], poly_geo[0], poly_geo[1])
    coord_u = uniform(k1[:, 3])
    # label 2 (_paste_scar): geo, colour, brightness, angle, copies, pastes
    k2 = split(k[:, 4], 6)
    scar_geo = _crop_geometry(k2[:, 0], spec.scar_area_ratio, aug.scar_aspect_ratio, spec.canvas)
    scar_col = _colorize(k2[:, 1], aug.color_probs)
    scar_bri = _brightness(k2[:, 2], aug)
    d["scar_angle"] = _randint_incl(k2[:, 3], *aug.scar_angle_range)
    d["scar_copies"] = _randint_incl(k2[:, 4], *aug.scar_copies)
    scar_u = uniform(split(k2[:, 5], max_copies))
    # label 3 (_draw_line): side, steps, colour, segment
    k3 = split(k[:, 4], 4)
    d["line_left"] = bernoulli(k3[:, 0])
    walk_u = uniform(k3[:, 1], (n_walk,))
    d["line_color"] = _randint_incl(k3[:, 2], 0, 2)
    d["line_segment"] = _randint_incl(k3[:, 3], 0, aug.line_splits - 1)
    if not patch:  # the presampled coordinates (batched_synthesizer)
        kp = split(fold_in(keys, PRESAMPLE_FOLD), 3)
        coord_u = uniform(kp[:, 0])
        scar_u = uniform(kp[:, 1], (max_copies,))
        walk_u = uniform(kp[:, 2], (n_walk,))
    d["coord_u"], d["scar_u"], d["walk_u"] = coord_u, scar_u, walk_u

    is_scar = d["label"] == 2
    for name, a, b in zip(("defect_w", "defect_h", "src_left", "src_top"), poly_geo, scar_geo):
        d[name] = np.where(is_scar, b, a)
    d["color_mode"] = np.where(is_scar, scar_col[0], poly_col[0])
    d["flat_rgb"] = np.where(is_scar[:, None], scar_col[1], poly_col[1])
    d["brightness"] = np.where(is_scar, scar_bri, poly_bri)

    # the final colour jitter (ops/image.py color_jitter)
    kj = split(k[:, 5], 4)
    v = aug.jitter_offset
    d["jitter"] = np.stack([uniform(kj[:, i], (), max(0.0, 1 - v), 1 + v) for i in (1, 2, 3)],
                           axis=-1)
    d["jitter_order"] = randint(kj[:, 0], (), 0, 6)

    fields = {}
    for name, a in d.items():
        a = np.asarray(a)
        if a.dtype == np.bool_:
            fields[name] = torch.from_numpy(a.copy())
        elif np.issubdtype(a.dtype, np.integer):
            fields[name] = torch.from_numpy(a.astype(np.int64))
        else:
            fields[name] = torch.from_numpy(a.astype(np.float32))
    return SynthDraws(**fields)


# --- the trainer's and the evaluator's schedules -------------------------------


def _epoch_steps(n_files: int, min_len: int, batch: int) -> int:
    """The JAX trainer's epoch length (ssad_tpu/train/trainer.py
    ``_epoch_steps``): the file list duplicated to at least ``min_len``,
    then whole batches only."""
    if n_files == 0:
        return 0
    return max(n_files * max(math.ceil(min_len / n_files), 1) // batch, 1)


@dataclasses.dataclass
class StepKey:
    """One step of a JAX ``Trainer.fit``: its kind (``train`` or ``eval``),
    stage and key."""

    kind: str
    stage: str
    key: np.ndarray


class JaxTrainStream:
    """The JAX ``Trainer.fit(seed)``'s random stream for one subject
    (ssad_tpu/train/trainer.py ``fit``, ``run_stage``, ``_make_batch``).

    ``fold_in(key(seed), 0 | 1 | 2)`` are the init, projection and
    fine-tune keys.  In a stage, each train step and then each validation
    step of an epoch takes ``rng, k = split(rng)``; a step's batch is
    ``k_idx, k_syn = split(k)``, indices ``randint(k_idx, (b,), 0, n)``
    of its split's ``n`` images, and the synthesizer's keys ``split(k_syn,
    b)``.  ``batches`` yields ``(kind, indices, SynthDraws)`` in the order
    the port's ``Trainer.run_stage`` asks for them (``upload_draws``)."""

    #: an epoch's steps: the train steps, then the validation steps
    ORDER = ("train", "eval")

    def __init__(self, seed: int, n_train: int, n_val: int, batch: int, *,
                 epochs: Tuple[int, int] = (10, 30), min_len: int = 1000,
                 val_batches: Optional[int] = None):
        self.seed, self.n_train, self.n_val, self.batch = int(seed), n_train, n_val, batch
        self.epochs = tuple(epochs)
        self.steps = _epoch_steps(n_train, min_len, batch)
        val_steps = max(_epoch_steps(max(n_val, 1), min_len, batch), 1)
        self.val_steps = val_steps if val_batches is None else min(val_steps, val_batches)

    def keys(self) -> Iterator[StepKey]:
        """Every step's key, in the order ``fit`` uses them."""
        base = key(self.seed)
        for index, (stage, epochs) in enumerate(zip(("projection", "fine_tune"), self.epochs)):
            rng = fold_in(base, index + 1)
            for _ in range(epochs):
                for kind in self.ORDER:
                    for _ in range(self.steps if kind == "train" else self.val_steps):
                        rng, k = split(rng, 2)
                        yield StepKey(kind, stage, k)

    def batch_of(self, step: StepKey, spec, n_cut: int):
        """A step key → (indices (b,) int64, SynthDraws)."""
        k_idx, k_syn = split(step.key, 2)
        n = self.n_train if step.kind == "train" else self.n_val
        idx = randint(k_idx, (self.batch,), 0, n)
        return (torch.from_numpy(idx.astype(np.int64)),
                jax_draws_np(spec, split(k_syn, self.batch), n_cut))

    def batches(self, spec, n_cut: int) -> Iterator[Tuple[str, torch.Tensor, object]]:
        """(kind, indices, SynthDraws) of every step, in order."""
        for step in self.keys():
            yield (step.kind, *self.batch_of(step, spec, n_cut))


def artificial_batches(spec, n_images: int, n_cut: int, num_samples: int, batch_size: int,
                       seed: int):
    """The JAX ``predict_artificial``'s indices and draws per batch
    (ssad_tpu/evaluation/inference.py: ``rng, k_idx, k_syn = split(rng,
    3)`` per batch from ``key(seed)``), with the signature of the port's
    ``evaluation.inference.artificial_batches``."""
    rng = key(seed)
    for _ in range(0, num_samples, batch_size):
        rng, k_idx, k_syn = split(rng, 3)
        idx = randint(k_idx, (batch_size,), 0, n_images)
        yield (torch.from_numpy(idx.astype(np.int64)),
               jax_draws_np(spec, split(k_syn, batch_size), n_cut))


def fit_permutation(seed: int, m: int) -> torch.Tensor:
    """The JAX detector's 70/30 permutation of ``m`` normality rows
    (ssad_tpu/models/detector.py ``fit``: ``permutation(key(seed), m)``)."""
    return torch.from_numpy(permutation(key(seed), m).astype(np.int64))


def stream_digest(seed: int = 0, n_train: int = 32, n_val: int = 8, batch: int = 96) -> str:
    """SHA-256 over the first train batch of ``JaxTrainStream(seed, …)`` for
    the bottle at 256² (its indices and every draw's bytes): a check that a
    machine's numpy gives the stream this module gives here."""
    from ssad_tpu_torch.data.synthetic import SynthSpec

    stream = JaxTrainStream(seed, n_train, n_val, batch)
    spec = SynthSpec(subject="bottle", imsize=(256, 256))
    idx, draws = stream.batch_of(next(stream.keys()), spec, 1)
    m = hashlib.sha256(idx.numpy().tobytes())
    for f in dataclasses.fields(draws):
        v = getattr(draws, f.name)
        if isinstance(v, torch.Tensor):
            m.update(f.name.encode())
            m.update(v.numpy().tobytes())
    return m.hexdigest()
