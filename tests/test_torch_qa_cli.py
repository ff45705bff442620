"""The port's ``cli qa`` (the augmentation visual-QA grid) on the CPU, and
the synthesizer's port-only contracts: the output of its own draws, the
forced-good rule of patch mode and the placeholder-coordinates guard."""

import json

import numpy as np
import pytest
import torch
from _torch_synth import batch_inputs
from PIL import Image

from ssad_tpu_torch import cli
from ssad_tpu_torch.constants import PRETEXT_CLASSES
from ssad_tpu_torch.data import synthetic as syn
from ssad_tpu_torch.evaluation.visualization import GRID_COLUMNS, augmentation_grid

torch.set_num_threads(1)


@pytest.mark.parametrize("patch", [False, True], ids=["image", "patch"])
def test_cli_qa_writes_the_grid(fake_mvtec, tmp_path, capsys, patch):
    argv = ["qa", "--dataset-dir", str(fake_mvtec), "--subject", "bottle", "--imsize", "64",
            "--outputs-dir", str(tmp_path), "--device", "cpu"]
    if patch:
        argv += ["--patch-level", "--patch-size", "32"]
    assert cli.main(argv) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"grid", "label_counts"}
    assert sum(out["label_counts"]) == cli.QA_BATCH and len(out["label_counts"]) == 4
    path = tmp_path / "bottle" / "dataset_analysis" / "bottle_augmentations.png"
    assert out["grid"] == str(path) and path.exists()
    with Image.open(path) as img:
        side = 32 if patch else 64
        assert img.mode == "RGB" and img.size[1] == len(PRETEXT_CLASSES) * (side + 4)


def test_augmentation_grid_rows_follow_the_pretext_classes(tmp_path):
    """Row r holds class r's samples, grey level r/4 here, up to
    GRID_COLUMNS of them; the rest of a row stays white."""
    n = {0: 1, 1: 3, 2: GRID_COLUMNS, 3: GRID_COLUMNS + 2}
    groups = {lbl: [np.full((8, 8, 3), lbl / 4, np.float32)] * n[lbl] for lbl in range(4)}
    grid = np.asarray(Image.open(augmentation_grid(groups, tmp_path, "g.png")))
    assert grid.shape == (4 * 12, 96 + GRID_COLUMNS * 12, 3)
    for lbl in range(4):
        for c in range(GRID_COLUMNS):
            cell = grid[lbl * 12 + 4, 96 + c * 12 + 4]
            expect = round(lbl / 4 * 255) if c < n[lbl] else 255
            assert (cell == expect).all(), (lbl, c, cell)


def _run(spec, draws, per_image=False, masks=None):
    imgs, pool, m, coords, counts = batch_inputs(len(draws.label), per_image,
                                                 placeholder_coords=spec.patch_localization)
    if masks is not None:
        m = masks
    return syn.synthesize(spec, draws, torch.from_numpy(imgs), torch.from_numpy(pool),
                          torch.from_numpy(m), torch.from_numpy(coords), torch.as_tensor(counts))


@pytest.mark.parametrize("subject, patch", [("bottle", False), ("hazelnut", False),
                                            ("carpet", False), ("screw", True)])
def test_own_draws_give_a_deterministic_batch(subject, patch):
    spec = syn.SynthSpec(subject=subject, imsize=(64, 64), patch_localization=patch,
                         patch_size=32)
    draws = syn.draw(spec, 12, torch.Generator().manual_seed(3), n_cut=2)
    x, y, orig = _run(spec, draws, per_image=spec.is_non_fixed)
    side = 32 if patch else 64
    assert x.shape == (12, side, side, 3) and x.dtype == torch.float32
    assert torch.isfinite(x).all() and y.shape == (12,)
    again = _run(spec, syn.draw(spec, 12, torch.Generator().manual_seed(3), n_cut=2),
                 per_image=spec.is_non_fixed)
    assert torch.equal(x, again[0]) and torch.equal(y, again[1])


def test_patch_mode_forces_good_on_a_thin_mask():
    """Too little object in the crop → label 0 and only the jitter
    (datasets.py:258-259): with an empty mask every sample is 'good'."""
    spec = syn.SynthSpec(subject="bottle", imsize=(64, 64), patch_localization=True,
                         patch_size=32)
    draws = syn.draw(spec, 16, torch.Generator().manual_seed(4))
    assert (draws.label > 0).any()
    x, y, _ = _run(spec, draws, masks=np.zeros((64, 64), np.float32))
    assert (y == 0).all()
    good = draws.to("cpu")
    good.label = torch.zeros_like(draws.label)
    good.label_order, good.label_counts = torch.arange(16), (16, 0, 0, 0)
    ref, _, _ = _run(spec, good, masks=np.zeros((64, 64), np.float32))
    assert torch.equal(x, ref)


def test_image_level_refuses_placeholder_coordinates():
    spec = syn.SynthSpec(subject="hazelnut", imsize=(64, 64))
    draws = syn.draw(spec, 4, torch.Generator().manual_seed(5))
    with pytest.raises(ValueError, match="placeholder"):
        syn.synthesize(spec, draws, torch.zeros(4, 64, 64, 3), torch.zeros(1, 64, 64, 3),
                       torch.ones(4, 64, 64), torch.zeros(4, 1, 2, dtype=torch.int32),
                       torch.zeros(4, dtype=torch.int32))


def test_static_tiles_match_the_jax_spec():
    from ssad_tpu.data.synthetic import SynthSpec as JaxSpec

    for subject, size, patch, p in (("bottle", 256, False, 64), ("screw", 256, True, 64),
                                    ("carpet", 64, True, 32), ("capsule", 256, True, 64)):
        ours = syn.SynthSpec(subject=subject, imsize=(size, size), patch_localization=patch,
                             patch_size=p)
        ref = JaxSpec(subject=subject, imsize=(size, size), patch_localization=patch,
                      patch_size=p)
        assert (ours.poly_tile, ours.scar_tile, ours.canvas, ours.precrop) == (
            ref.poly_tile, ref.scar_tile, ref.canvas, ref.precrop)
