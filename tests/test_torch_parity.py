"""The accuracy-parity harness (ssad_tpu_torch/parity.py, ``cli parity``)
against the JAX package's (ssad_tpu/parity.py).

Held: the synthetic dataset byte for byte (every PNG and manifest.json);
``merge_summaries`` and ``_write_summary_md`` equal to JAX's on the cases
of tests/test_parity.py; the manifest and fingerprint refusals with JAX's
messages; the evaluation half of ``run_parity`` (both packages skip
training on checkpoints of the same f32 weights, the port draws as JAX
does) at image level (``_torch_parity.check_evaluation_half``; patch
level and a whole port run: tests/test_torch_parity_patch.py).  Each
test makes its own seeded data (not conftest's shared ``rng``).

The JAX package's object masks here are its OpenCV path's, which the
port computes bit for bit without OpenCV: these comparisons need
OpenCV on the machine that runs the tests (without it the JAX package
takes its numpy fallback, which the port does not compute)."""

import json

import pytest
import torch
from _torch_eval import files_under
from _torch_parity import check_evaluation_half

from ssad_tpu import parity as jparity
from ssad_tpu_torch import parity

torch.set_num_threads(1)


def test_synthetic_dataset_is_byte_identical_to_jax(tmp_path):
    kw = dict(imsize=48, n_train=3, n_test_good=2, n_test_defect=4, seed=5)
    jparity.generate_parity_dataset(tmp_path / "jax", **kw)
    parity.generate_parity_dataset(tmp_path / "port", **kw)
    names = files_under(tmp_path / "jax")
    assert names == files_under(tmp_path / "port")
    assert len(names) == 3 * (3 + 2 + 4 + 4) + 1
    for name in names:
        got, want = (tmp_path / "port" / name).read_bytes(), (tmp_path / "jax" / name).read_bytes()
        assert got == want, name


_PRIOR_AND_FRESH = {
    "subject-subset-rerun": (
        {"image": {"image_auroc": 0.90, "reference": {"image_auroc": 0.9401},
                   "per_subject": {"bottle": {"image_auroc": 0.95},
                                   "carpet": {"image_auroc": 0.85}}}},
        {"image": {"image_auroc": 0.99, "reference": {"image_auroc": 0.9401},
                   "per_subject": {"bottle": {"image_auroc": 0.99}}}}),
    "other-mode-kept": (
        {"patch": {"pixel_auroc": 0.92, "per_subject": {"x": {"pixel_auroc": 0.92}}}},
        {"image": {"image_auroc": 0.95, "per_subject": {"x": {"image_auroc": 0.95}}}}),
    "fresh-not-mutated": (
        {"image": {"image_auroc": 0.9, "per_subject": {"a": {"image_auroc": 0.9}}}},
        {"image": {"image_auroc": 0.5, "per_subject": {"b": {"image_auroc": 0.5}}}}),
}


@pytest.mark.parametrize("case", sorted(_PRIOR_AND_FRESH))
def test_merge_and_summary_md_match_jax(tmp_path, case):
    prior, fresh = _PRIOR_AND_FRESH[case]
    fresh_copy = json.loads(json.dumps(fresh))
    got, want = parity.merge_summaries(prior, fresh), jparity.merge_summaries(prior, fresh)
    assert got == want
    assert fresh == fresh_copy
    subjects = sorted({s for m in got.values() for s in m["per_subject"]})
    for name, mod in (("port", parity), ("jax", jparity)):
        (tmp_path / name).mkdir()
        mod._write_summary_md(tmp_path / name, got, "ds", subjects)
    assert (tmp_path / "port" / "PARITY_SUMMARY.md").read_text() == \
        (tmp_path / "jax" / "PARITY_SUMMARY.md").read_text()


def _stale_manifest(out):
    ds = out / "synthetic_dataset"
    ds.mkdir(parents=True)
    (ds / "manifest.json").write_text(json.dumps({"subjects": ["bottle"], "imsize": 32,
                                                  "seed": 0}))


def _other_fingerprint(out):
    ds = out / "synthetic_dataset"
    ds.mkdir(parents=True)
    (ds / "manifest.json").write_text(json.dumps({"subjects": ["bottle"], "imsize": 64,
                                                  "seed": 0}))
    models = out / "image_level" / "models"
    models.mkdir(parents=True)
    (models / "parity_run.json").write_text(json.dumps({"backbone": "resnet34"}))


@pytest.mark.parametrize("setup", [_stale_manifest, _other_fingerprint],
                         ids=["stale-manifest", "other-fingerprint"])
def test_refusals_match_jax(tmp_path, setup):
    setup(tmp_path)
    kw = dict(dataset_dir=None, outputs_dir=str(tmp_path), subjects=["bottle"], imsize=64,
              modes=("image",), verbose=False)
    with pytest.raises(SystemExit) as want:
        jparity.run_parity(**kw)
    with pytest.raises(SystemExit) as got:
        parity.run_parity(**kw, device="cpu")
    assert str(got.value) == str(want.value) and str(want.value)


def test_image_level_evaluation_half_matches_jax(tmp_path):
    check_evaluation_half(tmp_path, "image", ["hazelnut"])
