"""The evaluation slice's data: the MVTec test set and its file layout
(``data/mvtec.py``, ``utils/filesystem.py``, ``utils/convert.py``) and
``EvalConfig``, against the JAX package's on ``fake_mvtec``
(tests/conftest.py).  Images, masks, labels and filenames must be equal.
Both packages decode with their native loaders where they build (the
port's is a copy of the JAX package's: tests/test_torch_native_loader.py)
and with PIL otherwise, so they agree bit for bit at 64² (nothing
resized) and at 48×40; with both native loaders off, both PIL paths
agree too."""

import numpy as np
import pytest
import torch

from ssad_tpu.config import EvalConfig as JEvalConfig
from ssad_tpu.data import mvtec as jm
from ssad_tpu.utils import convert as jconvert
from ssad_tpu.utils import filesystem as jfs
from ssad_tpu_torch.config import EvalConfig
from ssad_tpu_torch.data import mvtec as pm
from ssad_tpu_torch.utils import convert
from ssad_tpu_torch.utils import filesystem as fs


@pytest.mark.parametrize("subject", ["bottle", "carpet"])
@pytest.mark.parametrize("imsize", [(64, 64), (48, 40)])
def test_test_data_equals_jax(fake_mvtec, subject, imsize):
    got = pm.prepare_mvtec_test_data(fake_mvtec, subject, imsize=imsize)
    want = jm.prepare_mvtec_test_data(fake_mvtec, subject, imsize=imsize)
    assert got.filenames == want.filenames and got.imsize == want.imsize
    for name in ("images", "ground_truths", "labels"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert got.labels.tolist() == [1, 1, 0, 0]  # broken/ before good/, each sorted


@pytest.mark.parametrize("subject", ["bottle", "carpet"])
def test_test_data_equals_jax_on_the_pil_path(fake_mvtec, monkeypatch, subject):
    from ssad_tpu import native as jnative
    from ssad_tpu_torch import native

    for mod in (jnative, native):
        monkeypatch.setattr(mod, "decode_resize_batch", lambda *a, **k: None)
    got = pm.prepare_mvtec_test_data(fake_mvtec, subject, imsize=(48, 40))
    want = jm.prepare_mvtec_test_data(fake_mvtec, subject, imsize=(48, 40))
    for name in ("images", "ground_truths", "labels"):
        assert np.array_equal(getattr(got, name), getattr(want, name)), name


def test_layout_helpers_equal_jax(fake_mvtec, tmp_path):
    cat = fake_mvtec / "bottle"
    files = fs.test_images(cat)
    assert files == jfs.test_images(cat) and len(files) == 4
    assert fs.test_images(tmp_path) == [] == jfs.test_images(tmp_path)
    for f in files:
        assert fs.ground_truth_path(f) == jfs.ground_truth_path(f)
    assert [fs.ground_truth_path(f) is None for f in files] == [False, False, True, True]
    for n in (0, 3, 9):
        assert fs.duplicate_to_length(files, n) == jfs.duplicate_to_length(files, n)
    assert fs.duplicate_to_length([], 5) == []
    assert fs.ensure_dir(tmp_path / "a" / "b").is_dir()
    mask = fs.ground_truth_path(files[0])
    assert np.array_equal(pm.load_mask(mask, (64, 64)), jm.load_mask(mask, (64, 64)))
    assert np.array_equal(pm.load_mask(None, (8, 8)), np.zeros((8, 8), np.float32))


def test_missing_test_split_raises(tmp_path):
    (tmp_path / "bottle").mkdir()
    with pytest.raises(FileNotFoundError):
        pm.prepare_mvtec_test_data(tmp_path, "bottle")


def test_label_conversions_equal_jax():
    rng = np.random.default_rng(0)
    gts = (rng.random((6, 8, 8)) > 0.97).astype(np.float32)
    gts[0] = 0
    logits = rng.normal(size=(6, 4)).astype(np.float32)
    assert np.array_equal(convert.gt2label(torch.from_numpy(gts)).numpy(),
                          np.asarray(jconvert.gt2label(gts)))
    assert np.array_equal(convert.gt2label(torch.from_numpy(gts), -1, 4).numpy(),
                          np.asarray(jconvert.gt2label(gts, -1, 4)))
    assert np.array_equal(convert.prediction_class(torch.from_numpy(logits)).numpy(),
                          np.asarray(jconvert.prediction_class(logits)))
    labels = np.array([0, 1, 2, 3, 0])
    assert np.array_equal(convert.multiclass2binary(torch.from_numpy(labels)).numpy(),
                          np.asarray(jconvert.multiclass2binary(labels)))
    x = rng.random(10)
    assert np.array_equal(convert.normalize_in_interval(x, 0, 255),
                          jconvert.normalize_in_interval(x, 0, 255))
    np.testing.assert_allclose(convert.minmax_normalize(torch.from_numpy(x)).numpy(),
                               np.asarray(jconvert.minmax_normalize(x)), rtol=0, atol=1e-7)
    assert np.array_equal(convert.image_to_uint8(x[:6].reshape(1, 2, 3)),
                          jconvert.image_to_uint8(x[:6].reshape(1, 2, 3)))


def test_eval_config_defaults_equal_jax_and_unported_options_raise():
    import dataclasses

    got, want = dataclasses.asdict(EvalConfig()), dataclasses.asdict(JEvalConfig())
    assert got == want
    assert EvalConfig(imsize=(128, 128)).upsample_size == 128
    # the scorers are ported: both are taken, with a coreset, as the JAX
    # config takes them
    for kw in (dict(scorer="mahalanobis"), dict(coreset=100),
               dict(scorer="mahalanobis", coreset=100)):
        assert dataclasses.asdict(EvalConfig(**kw)) == dataclasses.asdict(JEvalConfig(**kw))
    # sharding is ported (slice 9): taken as the JAX config takes it
    for kw in (dict(data_shards=2), dict(category_shards=4)):
        assert dataclasses.asdict(EvalConfig(**kw)) == dataclasses.asdict(JEvalConfig(**kw))
    assert EvalConfig(data_shards=1, category_shards=1).data_shards == 1
    with pytest.raises(ValueError):
        EvalConfig(scorer="lof")
