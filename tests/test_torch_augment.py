"""The port's augmentation ops and rasterisers against the JAX package.

Same seeded numpy inputs on both sides; random parameters are read from
the JAX key the JAX op draws from and handed to the port.  Tolerances:
* augmentation ops: ≥ 99.9 % of elements within one bf16 ulp on the
  [0, 1] scale (2⁻⁸); XLA may keep f32 between fused bf16 ops where torch
  rounds after each, and a shear shift may round the other way at .5;
* ``mean_color`` / ``color_cosine_similarity``: 1e-6 (f32 sums in another
  order);
* ``polygon_mask`` / ``polyline_mask``: ≥ 99.9 % of pixels equal;
  ``savgol_matrix``: 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import seeded

from ssad_tpu.ops import image as jim
from ssad_tpu.ops import rasterize as jras
from ssad_tpu_torch.ops import image as im
from ssad_tpu_torch.ops import rasterize as ras

torch.set_num_threads(1)
ULP, SHARE = 2.0**-8, 0.999
SIZE = 48


def _bf16_image(seed, shape=(SIZE, SIZE, 3)):
    x = seeded(shape, seed)
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


def _assert_within_ulp(ours, ref):
    ours = ours.float().numpy()
    ref = np.asarray(ref, np.float32)
    assert ours.shape == ref.shape
    within = np.abs(ours - ref) <= ULP
    assert within.mean() >= SHARE, (within.mean(), np.abs(ours - ref).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_denormalize_imagenet_matches_jax(dtype):
    x = seeded((4, 8, 8, 3), 1, -2.0, 2.0)
    ref = jim.denormalize_imagenet(jnp.asarray(x, dtype))
    ours = im.denormalize_imagenet(torch.from_numpy(x).to(getattr(torch, dtype)))
    np.testing.assert_array_equal(ours.float().numpy(), np.asarray(ref, np.float32))
    back = im.normalize_imagenet(im.denormalize_imagenet(torch.from_numpy(x)))
    np.testing.assert_allclose(back.numpy(), x, atol=1e-5)


@pytest.mark.parametrize("seed", range(8))
def test_color_jitter_with_given_draws_matches_jax(seed):
    """The JAX op draws (factors, order) from its key; the port is handed
    the same draws.  Eight keys reach every one of the six orders."""
    key = jax.random.key(seed)
    k_perm, kb, kc, ks = jax.random.split(key, 4)
    factors = np.array([float(jax.random.uniform(k, (), minval=0.9, maxval=1.1))
                        for k in (kb, kc, ks)], np.float32)
    order = int(jax.random.randint(k_perm, (), 0, 6))
    jx, tx = _bf16_image(10 + seed)
    ref = jim.color_jitter(key, jx, 0.1, 0.1, 0.1)
    ours = im.color_jitter(tx, torch.from_numpy(factors), order)
    _assert_within_ulp(ours, ref)


def test_color_jitter_batch_matches_per_image():
    """One row of factors and one order per image of a batch: the same as
    jittering each image alone (every order once)."""
    _, tx = _bf16_image(3, (6, 16, 16, 3))
    factors = torch.from_numpy(seeded((6, 3), 4, 0.9, 1.1))
    orders = torch.arange(6)
    batch = im.color_jitter(tx, factors, orders)
    for i in range(6):
        assert torch.equal(batch[i], im.color_jitter(tx[i], factors[i], int(orders[i])))


@pytest.mark.parametrize("seed", range(4))
def test_random_affine_with_given_draws_matches_jax(seed):
    key = jax.random.key(100 + seed)
    ka, ks = jax.random.split(key)
    angle = float(jax.random.uniform(ka, (), minval=-3.0, maxval=3.0))
    scale = float(jax.random.uniform(ks, (), minval=1.05, maxval=1.1))
    jx, tx = _bf16_image(20 + seed)
    ref = jim.random_affine(key, jx, 3.0, (1.05, 1.1))
    ours = im.random_affine(tx, torch.tensor(angle), torch.tensor(scale), 3.0)
    _assert_within_ulp(ours, ref)


def test_random_affine_batch_matches_per_image():
    _, tx = _bf16_image(5, (3, SIZE, SIZE, 3))
    angles, scales = torch.tensor([-2.5, 0.3, 2.9]), torch.tensor([1.05, 1.08, 1.1])
    batch = im.random_affine(tx, angles, scales, 3.0)
    for i in range(3):
        assert torch.equal(batch[i], im.random_affine(tx[i], angles[i], scales[i], 3.0))


@pytest.mark.parametrize("angle", [-3.0, -1.3, 0.0, 0.7, 2.2, 3.0])
def test_rotate_small_angle_matches_jax(angle):
    x = seeded((SIZE, SIZE, 3), 30)
    ref = jim.rotate_small_angle(jnp.asarray(x), jnp.float32(angle), 3.0)
    ours = im.rotate_small_angle(torch.from_numpy(x), torch.tensor(angle), 3.0)
    _assert_within_ulp(ours, ref)


@pytest.mark.parametrize("angle, scale", [(0.0, 1.0), (2.0, 1.0), (-2.7, 1.08)])
def test_affine_nearest_oracle_matches_jax(angle, scale):
    """The per-pixel nearest oracle the JAX tests hold affines to."""
    x = seeded((SIZE, SIZE, 3), 31)
    ours = im.affine_nearest(torch.from_numpy(x), torch.tensor(angle), torch.tensor(scale))
    ref = jim.affine_nearest(jnp.asarray(x), jnp.float32(angle), jnp.float32(scale))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("scale", [1.05, 1.0731, 1.1])
def test_scale_about_center_matches_jax(scale):
    jx, tx = _bf16_image(40)
    ref = jim.scale_about_center(jx, jnp.float32(scale))
    ours = im.scale_about_center(tx, torch.tensor(scale))
    _assert_within_ulp(ours, ref)


def test_mean_color_and_cosine_similarity_match_jax():
    x = seeded((SIZE, SIZE, 3), 50)
    jm = jim.mean_color(jnp.asarray(x, jnp.bfloat16))
    tm = im.mean_color(torch.from_numpy(x).to(torch.bfloat16))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-6, rtol=0)
    other = seeded((3,), 51)
    np.testing.assert_allclose(
        float(im.color_cosine_similarity(tm, torch.from_numpy(other))),
        float(jim.color_cosine_similarity(jm, jnp.asarray(other))), atol=1e-6, rtol=0)


def _random_polygons(seed, n=12, size=40):
    rng = np.random.default_rng(seed)
    verts = rng.uniform(-4, size + 4, (n, 8, 2)).astype(np.float32)
    counts = rng.integers(3, 9, n)
    return verts, counts


def test_polygon_mask_matches_jax():
    verts, counts = _random_polygons(60)
    ours = ras.polygon_mask(torch.from_numpy(verts), torch.from_numpy(counts), (40, 40))
    for i in range(len(verts)):
        ref = np.asarray(jras.polygon_mask(jnp.asarray(verts[i]), jnp.int32(counts[i]), (40, 40)))
        assert (ours[i].numpy() == ref).mean() >= SHARE


@pytest.mark.parametrize("width", [1.0, 3.0])
def test_polyline_mask_matches_jax(width):
    rng = np.random.default_rng(int(width))
    pts = rng.uniform(0, 40, (6, 10, 2)).astype(np.float32)
    counts = np.array([2, 3, 5, 7, 10, 10])
    ours = ras.polyline_mask(torch.from_numpy(pts), torch.from_numpy(counts), width, (40, 40))
    for i in range(len(pts)):
        ref = np.asarray(jras.polyline_mask(jnp.asarray(pts[i]), jnp.int32(counts[i]), width,
                                            (40, 40)))
        assert (ours[i].numpy() == ref).mean() >= SHARE


def test_rotated_rect_mask_matches_jax():
    args = (np.array([20.0, 17.5], np.float32), 13.0, 5.0, 30.0)
    ref = jras.rotated_rect_mask(jnp.asarray(args[0]), *args[1:], (40, 40))
    ours = ras.rotated_rect_mask(torch.from_numpy(args[0]), *args[1:], (40, 40))
    assert (ours.numpy() == np.asarray(ref)).mean() >= SHARE


@pytest.mark.parametrize("n", [30, 60])
def test_savgol_matrix_and_smoothing_match_jax(n):
    np.testing.assert_allclose(ras.savgol_matrix(n), jras.savgol_matrix(n), atol=1e-6, rtol=0)
    pts = seeded((n, 2), n, 0, 64)
    np.testing.assert_allclose(
        ras.smooth_polyline(torch.from_numpy(pts), torch.from_numpy(ras.savgol_matrix(n))).numpy(),
        np.asarray(jras.smooth_polyline(jnp.asarray(pts))), atol=1e-4, rtol=1e-6)


def test_savgol_fallback_is_the_jax_moving_average(monkeypatch):
    """Without scipy both packages fall back to the same moving average."""
    import builtins

    real_import = builtins.__import__

    def no_scipy(name, *a, **k):
        if name.startswith("scipy"):
            raise ImportError(name)
        return real_import(name, *a, **k)

    ras.savgol_matrix.cache_clear()
    jras.savgol_matrix.cache_clear()
    monkeypatch.setattr(builtins, "__import__", no_scipy)
    try:
        ours, ref = ras.savgol_matrix(12), jras.savgol_matrix(12)
    finally:
        monkeypatch.undo()
        ras.savgol_matrix.cache_clear()
        jras.savgol_matrix.cache_clear()
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_allclose(ours.sum(axis=1), 1.0, atol=1e-6)
