"""The port's native PNG/JPEG loader (ssad_tpu_torch/native/loader.cpp,
bound in native/__init__.py) against the JAX package's (ssad_tpu/native).

Held: the same source but for its header comment; decodes bit-equal to the
JAX package's native decode on RGB and grayscale PNGs and on JPEGs, at
their own size and resized; palette, alpha and 16-bit PNGs and
undecodable files left to PIL by both (``decode_resize_batch`` → None);
``load_stack`` and ``load_mask_stack`` equal to JAX's on those files; and
``SSAD_NATIVE=0`` builds nothing.  The files are made here from a seeded
numpy generator."""

import numpy as np
import pytest
import torch
from PIL import Image

from ssad_tpu import native as jnative
from ssad_tpu.data import mvtec as jmvtec
from ssad_tpu_torch import native
from ssad_tpu_torch.data import mvtec

torch.set_num_threads(1)


def _write(d, name, arr, **save):
    p = d / name
    Image.fromarray(arr).save(p, **save)
    return str(p)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """{kind: [paths]}: RGB and grayscale PNGs, JPEGs (native decode), and
    palette, alpha and 16-bit PNGs and an undecodable PNG (PIL)."""
    d = tmp_path_factory.mktemp("loader")
    rng = np.random.default_rng(11)
    sizes = [(97, 131), (64, 64), (120, 80)]
    rgb = [(rng.random(s + (3,)) * 255).astype(np.uint8) for s in sizes]
    out = {
        "rgb_png": [_write(d, f"rgb{i}.png", a) for i, a in enumerate(rgb)],
        "gray_png": [_write(d, f"gray{i}.png", a[..., 0]) for i, a in enumerate(rgb)],
        "jpeg": [_write(d, f"img{i}.jpg", a, quality=90) for i, a in enumerate(rgb)],
        "palette_png": [str(d / "pal.png")],
        "alpha_png": [_write(d, "rgba.png", np.dstack([rgb[0], rgb[0][..., :1]]))],
        "16bit_png": [_write(d, "deep.png", (rng.random(sizes[1]) * 65535).astype(np.uint16))],
    }
    Image.fromarray(rgb[1]).convert("P", palette=Image.ADAPTIVE).save(out["palette_png"][0])
    broken = d / "broken.png"
    broken.write_bytes(open(out["rgb_png"][0], "rb").read()[:200])  # IHDR intact, data cut
    out["broken_png"] = [str(broken)]
    return out


@pytest.fixture(scope="module")
def both_built():
    if not jnative.available():
        pytest.skip("the JAX package's native loader is not built here (no g++/libpng)")
    assert native.available(), "the JAX loader builds here, so the port's must"


def test_source_is_the_jax_loader_but_for_its_header():
    def body(path):
        src = path.read_text()
        return src[src.index("#include <png.h>"):]

    assert body(native.NATIVE_DIR / "loader.cpp") == body(jnative._SRC)


@pytest.mark.parametrize("imsize", [(64, 64), (72, 48), (160, 160)])
@pytest.mark.parametrize("kind,channels", [("rgb_png", 3), ("gray_png", 3), ("gray_png", 1),
                                           ("jpeg", 3), ("rgb_png", 1)])
def test_native_decode_is_bit_equal_to_jax(files, both_built, kind, channels, imsize):
    got = native.decode_resize_batch(files[kind], imsize, channels=channels)
    want = jnative.decode_resize_batch(files[kind], imsize, channels=channels)
    assert got is not None and got.shape == (3,) + imsize + (channels,)
    np.testing.assert_array_equal(got, want)


def test_threads_do_not_change_the_result(files, both_built):
    paths = files["rgb_png"] * 3
    one = native.decode_resize_batch(paths, (48, 48), n_threads=1)
    np.testing.assert_array_equal(one, native.decode_resize_batch(paths, (48, 48), n_threads=4))


@pytest.mark.parametrize("kind", ["palette_png", "alpha_png", "16bit_png", "broken_png"])
def test_files_left_to_pil_by_both(files, both_built, kind):
    paths = files[kind] + files["rgb_png"][:1]  # one such file sends the batch to PIL
    assert native.decode_resize_batch(paths, (64, 64)) is None
    assert jnative.decode_resize_batch(paths, (64, 64)) is None
    assert native._png_needs_pil(files[kind][0]) == jnative._png_needs_pil(files[kind][0])
    assert native.decode_resize_batch(["/nonexistent.bmp"], (32, 32)) is None


@pytest.mark.parametrize("kind", ["rgb_png", "gray_png", "jpeg", "palette_png", "alpha_png",
                                  "16bit_png"])
def test_load_stack_equals_jax(files, both_built, kind):
    got = mvtec.load_stack(files[kind], (56, 56))
    np.testing.assert_array_equal(got, jmvtec.load_stack(files[kind], (56, 56)))
    pil = np.stack([mvtec.load_image(p, (56, 56)) for p in files[kind]])
    if kind.endswith("png") and kind not in ("rgb_png", "gray_png"):
        np.testing.assert_array_equal(got, pil)  # the PIL path
    else:
        assert np.abs(got - pil).max() < (4 if kind == "jpeg" else 2) / 255.0


def test_an_undecodable_file_fails_in_both(files, both_built):
    with pytest.raises(OSError) as want:
        jmvtec.load_stack(files["broken_png"], (32, 32))
    with pytest.raises(OSError) as got:
        mvtec.load_stack(files["broken_png"], (32, 32))
    assert type(got.value) is type(want.value)


def test_load_mask_stack_equals_jax(tmp_path, both_built):
    rng = np.random.default_rng(4)
    paths = []
    for i, size in enumerate([(100, 120), (64, 64)]):
        m = np.zeros(size, np.uint8)
        y, x = rng.integers(5, 40, 2)
        m[y:y + 30, x:x + 40] = 255
        paths.append(_write(tmp_path, f"gt{i}_mask.png", m))
    paths.append(_write(tmp_path, "rgb_mask.png", np.zeros((64, 64, 3), np.uint8)))
    for batch in ([None, paths[0], None, paths[1]], [paths[0], paths[2]], [None, None]):
        got = mvtec.load_mask_stack(batch, (64, 64))
        np.testing.assert_array_equal(got, jmvtec.load_mask_stack(batch, (64, 64)))
        for row, p in zip(got, batch):
            np.testing.assert_array_equal(row, mvtec.load_mask(p, (64, 64)))


def test_ssad_native_0_builds_nothing(monkeypatch):
    monkeypatch.setenv("SSAD_NATIVE", "0")
    assert native.build() is None
