"""Shared helpers of the port's synthesizer tests (tests/test_torch_synth*.py).

``jax_draws`` walks the JAX engine's key tree (ssad_tpu/data/synthetic.py:
``split(key, 8)`` per sample, ``split(keys[4], …)`` inside each branch,
``fold_in(key, 0x5A11)`` for the image-level presampled coordinates,
:857-869) and returns the port's ``SynthDraws`` holding the same draws, so
that ``synthesize`` and ``batched_synthesizer`` can be compared on the same
keys.  Where a JAX helper returns draws, it calls that helper.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ssad_tpu.data import masks as jmasks
from ssad_tpu.data import synthetic as js
from ssad_tpu_torch.data import synthetic as syn

#: whole-engine tolerance: per sample, this share of denormalised pixel
#: values within PIXEL_TOL (one bf16 ulp at 1.0 is 2⁻⁷).  At 64² the
#: limit leaves 24 values (8 pixels) of a sample free: one scar copy at
#: image level covers 12-29 pixels
PIXEL_TOL, PIXEL_SHARE = 2.0**-7, 0.998
IMSIZE, PATCH, BATCH = 64, 32, 24


def jax_spec(spec: syn.SynthSpec) -> js.SynthSpec:
    return js.SynthSpec(subject=spec.subject, imsize=tuple(spec.imsize),
                        patch_localization=spec.patch_localization,
                        patch_size=spec.patch_size)


def _colorize_draws(key, probs):
    k_t, k_r, k_g, k_b = jax.random.split(key, 4)
    u = jax.random.uniform(k_t, ())
    t = jnp.where(u < probs[0], 0, jnp.where(u < probs[0] + probs[1], 1, 2))
    rgb = jnp.stack([js._randint_incl(k, 0, 255) for k in (k_r, k_g, k_b)])
    return t, rgb


def _brightness_draws(key, aug):
    k_lo, k_hi, k_c1, k_c2 = jax.random.split(key, 4)
    low = jax.random.uniform(k_lo, (), minval=aug.brightness_low[0], maxval=aug.brightness_low[1])
    high = jax.random.uniform(k_hi, (), minval=aug.brightness_high[0],
                              maxval=aug.brightness_high[1])
    f1 = jnp.where(jax.random.bernoulli(k_c1), low, high)
    f2 = jnp.where(jax.random.bernoulli(k_c2), low, high)
    return f1 * f2


def jax_draws(spec: syn.SynthSpec, keys, n_cut: int) -> syn.SynthDraws:
    """The draws the JAX engine makes from ``keys`` (one per sample), as
    the port's SynthDraws on the CPU."""
    aug = spec.aug
    patch = spec.patch_localization
    h, w = spec.imsize
    p = spec.patch_size
    ch, cw = spec.precrop_hw
    cut_hw = spec.canvas
    n_walk, max_copies = spec.line_points, spec.max_copies

    def one(key):
        k = jax.random.split(key, 8)
        d = {"label": js._randint_incl(k[0], 0, 3)}
        ka, ks = jax.random.split(k[1])
        d["affine_angle"] = jax.random.uniform(ka, (), minval=-aug.affine_degrees,
                                               maxval=aug.affine_degrees)
        d["affine_scale"] = jax.random.uniform(ks, (), minval=aug.affine_scale[0],
                                               maxval=aug.affine_scale[1])
        d["cut_index"] = js._randint_incl(k[2], 0, max(n_cut - 1, 0))
        zero = jnp.int32(0)
        if patch:
            kx, ky, kc = jax.random.split(k[3], 3)
            kcl, kct = jax.random.split(kc)
            d["crop_left"] = js._randint_incl(kx, 0, cw - p)
            d["crop_top"] = js._randint_incl(ky, 0, ch - p)
            d["cut_left"] = js._randint_incl(kcl, 0, w - p)
            d["cut_top"] = js._randint_incl(kct, 0, h - p)
        else:
            d["crop_left"] = d["crop_top"] = d["cut_left"] = d["cut_top"] = zero

        # label 1's keys (_paste_polygon_patch)
        k_geo, k_col, k_bri, k_coord, k_poly = jax.random.split(k[4], 5)
        poly_geo = js._gen_crop_geometry(k_geo, spec.patch_area_ratio, aug.patch_aspect_ratio,
                                         cut_hw)
        poly_col = _colorize_draws(k_col, aug.color_probs)
        poly_bri = _brightness_draws(k_bri, aug)
        d["poly_vertices"], d["poly_count"] = js._polygon_vertices(k_poly, poly_geo[0],
                                                                   poly_geo[1])
        coord_u = jax.random.uniform(k_coord, ())
        # label 2's keys (_paste_scar)
        k_geo, k_col, k_bri, k_angle, k_k, k_pastes = jax.random.split(k[4], 6)
        scar_geo = js._gen_crop_geometry(k_geo, spec.scar_area_ratio, aug.scar_aspect_ratio,
                                         cut_hw)
        scar_col = _colorize_draws(k_col, aug.color_probs)
        scar_bri = _brightness_draws(k_bri, aug)
        d["scar_angle"] = js._randint_incl(k_angle, *aug.scar_angle_range)
        d["scar_copies"] = js._randint_incl(k_k, *aug.scar_copies)
        scar_u = jnp.stack([jax.random.uniform(kq, ())
                            for kq in jax.random.split(k_pastes, max_copies)])
        # label 3's keys (_draw_line)
        k_side, k_steps, k_color, k_split = jax.random.split(k[4], 4)
        d["line_left"] = jax.random.bernoulli(k_side)
        walk_u = jax.random.uniform(k_steps, (n_walk,))
        d["line_color"] = js._randint_incl(k_color, 0, 2)
        d["line_segment"] = js._randint_incl(k_split, 0, aug.line_splits - 1)

        if not patch:  # presample_indices' keys (batched_synthesizer :857-869)
            kp, ks3, kw = jax.random.split(jax.random.fold_in(key, 0x5A11), 3)
            coord_u = jax.random.uniform(kp, ())
            scar_u = jax.random.uniform(ks3, (max_copies,))
            walk_u = jax.random.uniform(kw, (n_walk,))
        d["coord_u"], d["scar_u"], d["walk_u"] = coord_u, scar_u, walk_u

        is_scar = d["label"] == 2
        for name, a, b in zip(("defect_w", "defect_h", "src_left", "src_top"), poly_geo, scar_geo):
            d[name] = jnp.where(is_scar, b, a)
        d["color_mode"] = jnp.where(is_scar, scar_col[0], poly_col[0])
        d["flat_rgb"] = jnp.where(is_scar, scar_col[1], poly_col[1])
        d["brightness"] = jnp.where(is_scar, scar_bri, poly_bri)

        # the final colour jitter (ops/image.py color_jitter)
        k_perm, kb, kc, ksat = jax.random.split(k[5], 4)
        v = aug.jitter_offset
        d["jitter"] = jnp.stack([
            jax.random.uniform(kk, (), minval=max(0.0, 1 - v), maxval=1 + v)
            for kk in (kb, kc, ksat)
        ])
        d["jitter_order"] = jax.random.randint(k_perm, (), 0, 6)
        return d

    raw = jax.jit(jax.vmap(one))(keys)
    fields = {}
    for name, val in raw.items():
        a = np.asarray(val)
        if a.dtype == np.bool_:
            fields[name] = torch.from_numpy(a.copy())
        elif np.issubdtype(a.dtype, np.integer):
            fields[name] = torch.from_numpy(a.astype(np.int64))
        else:
            fields[name] = torch.from_numpy(a.astype(np.float32))
    return syn.SynthDraws(**fields)


def scene(seed: int = 7, size: int = IMSIZE):
    """A textured (size, size, 3) image with a bright disc, its disc mask
    and packed coordinates (as tests/test_synthetic.py's scene)."""
    yy, xx = np.mgrid[0:size, 0:size]
    img = np.stack([0.3 + 0.3 * xx / size, 0.4 + 0.2 * yy / size,
                    0.5 * np.ones_like(xx, float)], -1).astype(np.float32)
    rng = np.random.default_rng(seed)
    img = np.clip(img + rng.normal(0, 0.08, img.shape).astype(np.float32), 0, 1)
    c = size // 2
    disc = ((yy - c) ** 2 + (xx - c) ** 2) < (0.35 * size) ** 2
    img[disc] = np.clip(img[disc] + 0.25, 0, 1)
    mask = disc.astype(np.uint8)
    coords, n = jmasks.pack_coords(mask)
    return img, mask, coords, n


def batch_inputs(n: int, per_image: bool, seed: int = 0, placeholder_coords: bool = False,
                 size: int = IMSIZE):
    """(images (n, H, W, 3), cut pool (2, H, W, 3), masks, coords, counts)
    as numpy: every image the scene with its own noise; per-image masks
    are discs shifted per image, with 1-row placeholder coordinates in
    patch mode (as prepare_pretext_data leaves them)."""
    img, mask, coords, count = scene(size=size)
    rng = np.random.default_rng(seed)
    imgs = np.clip(img[None] + rng.normal(0, 0.02, (n,) + img.shape), 0, 1).astype(np.float32)
    pool = np.stack([img, np.roll(img, 17, axis=0)])
    if not per_image:
        return imgs, pool, mask.astype(np.float32), coords, np.int32(count)
    ms, cs, ns = [], [], []
    for i in range(n):
        m = np.roll(mask, (i % 5) - 2, axis=(i % 2))
        c, k = (np.zeros((1, 2), np.int32), 0) if placeholder_coords else jmasks.pack_coords(m)
        ms.append(m.astype(np.float32))
        cs.append(c)
        ns.append(k)
    return imgs, pool, np.stack(ms), np.stack(cs), np.asarray(ns, np.int32)


@functools.lru_cache(maxsize=None)
def _jax_reference(spec: syn.SynthSpec, seed: int, n: int):
    """(numpy inputs, JAX batch and labels, the JAX draws as SynthDraws):
    one XLA compile per (spec, seed, n) and test process."""
    per_image = spec.is_non_fixed
    inputs = batch_inputs(n, per_image, seed, spec.patch_localization, spec.imsize[0])
    imgs, pool, masks, coords, counts = inputs
    keys = jax.random.split(jax.random.key(seed), n)
    fn = jax.jit(js.batched_synthesizer(jax_spec(spec), per_image_masks=per_image))
    ref_x, ref_y, _ = fn(keys, jnp.asarray(imgs), jnp.asarray(pool), jnp.int32(pool.shape[0]),
                         jnp.asarray(masks), jnp.asarray(coords), jnp.asarray(counts))
    return inputs, np.asarray(ref_x), np.asarray(ref_y), jax_draws(spec, keys, pool.shape[0])


def compare_engines(spec: syn.SynthSpec, seed: int = 0, n: int = BATCH, fault=None):
    """Run JAX's batched_synthesizer and the port's synthesize on the same
    keys and inputs; returns (labels, ref labels, per-sample share within
    PIXEL_TOL, largest |Δ|) of the denormalised outputs.  ``fault``, a
    function of the draws, plants a defect in the port's draws only."""
    (imgs, pool, masks, coords, counts), ref_x, ref_y, draws = _jax_reference(spec, seed, n)
    if fault is not None:
        draws = fault(draws)
    x, y, orig = syn.synthesize(spec, draws, torch.from_numpy(imgs), torch.from_numpy(pool),
                                torch.from_numpy(masks), torch.from_numpy(coords),
                                torch.as_tensor(counts))
    mean = np.asarray((0.485, 0.456, 0.406), np.float32)
    std = np.asarray((0.229, 0.224, 0.225), np.float32)
    ours = x.numpy() * std + mean
    theirs = ref_x * std + mean
    diff = np.abs(ours - theirs).reshape(n, -1)
    share = (diff <= PIXEL_TOL).mean(axis=1)
    assert orig.shape == imgs.shape
    return y.numpy(), ref_y, share, float(diff.max())


def readings_256(n: int = 16, seed: int = 0) -> None:
    """The readings behind tests/test_torch_synth_256.py's docstring: per
    regime at 256², the worst sample's share within PIXEL_TOL of the JAX
    engine at XLA's default; then, for each sample below PIXEL_SHARE, its
    jitter's share when one op at a time of ``ops.image`` runs at XLA's
    default and the others at declared precision."""
    from ssad_tpu.ops import image as jim
    from ssad_tpu_torch.ops import image as pim

    mean = np.asarray((0.485, 0.456, 0.406), np.float32)
    std = np.asarray((0.229, 0.224, 0.225), np.float32)
    declared = {"xla_allow_excess_precision": False}
    for subject in ("bottle", "hazelnut", "carpet"):
        spec = syn.SynthSpec(subject=subject, imsize=(256, 256))
        y, _, share, largest = compare_engines(spec, seed, n)
        print(f"{subject}: worst share {share.min():.5f} (sample {share.argmin()}), "
              f"largest |d| {largest:.4f}")
        (imgs, *_), ref_x, _, draws = _jax_reference(spec, seed, n)
        for i in np.flatnonzero((share < PIXEL_SHARE) & (y == 0)):
            fb, fc, fs = (jnp.asarray(float(v), jnp.bfloat16) for v in draws.jitter[i])
            ops = {"saturation": lambda x: jim.adjust_saturation(x, fs),
                   "contrast": lambda x: jim.adjust_contrast(x, fc),
                   "brightness": lambda x: jim.adjust_brightness(x, fb),
                   "normalize": jim.normalize_imagenet}
            order = [("brightness", "contrast", "saturation")[k]
                     for k in pim.JITTER_ORDERS[int(draws.jitter_order[i])]]

            def chain(default_op=None):
                x = jnp.asarray(imgs[i]).astype(jnp.bfloat16)
                for name in order + ["normalize"]:
                    opts = None if name == default_op else declared
                    x = jax.jit(ops[name], compiler_options=opts)(x)
                return np.asarray(x.astype(jnp.float32)) * std + mean

            base = chain()
            print(f"  sample {i} (label 0, order {order}): the declared chain against "
                  f"the engine at XLA's default: share "
                  f"{(np.abs(base - (ref_x[i] * std + mean)) <= PIXEL_TOL).mean():.5f}")
            for name in ops:
                d = chain(name) - base
                print(f"    {name} alone at XLA's default: {(np.abs(d) > PIXEL_TOL).mean():.5f} "
                      f"beyond 2^-7, largest {np.abs(d).max():.4f}, mean {d.mean():+.2e}")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    readings_256()
