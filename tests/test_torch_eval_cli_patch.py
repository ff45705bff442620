"""``python -m ssad_tpu_torch.cli evaluate --patch-level`` against the
JAX command on fake_mvtec's bottle, each from its own checkpoint of the
same f32 weights, the port on ``--device cpu`` with the JAX fit
permutation: the same stdout line (pixel AUROC, IoU, AUPRO to 4
decimals), every file the JAX command writes, the tables' labels and
numbers within 1e-3 (measured at most 6.3e-6: tests/
test_torch_evaluator_patch.py).  With ``--scorer mahalanobis`` or
``--coreset`` (the coreset's first center handed over too) the printed
numbers are held to that 1e-3 as well (the maps agree within the patch
path's tolerance, so a printed digit may round the other way: AUPRO
0.4506 against 0.4507 with the coreset).  ``cli infer``:
tests/test_torch_infer_cli.py and tests/test_torch_scorer_infer_cli.py.

The JAX package's object masks here are its OpenCV path's, which the
port computes bit for bit without OpenCV: these comparisons need
OpenCV on the machine that runs the tests (without it the JAX package
takes its numpy fallback, which the port does not compute)."""

import numpy as np
import pytest
from _torch_eval import (
    IMSIZE, assert_tables_match, files_under, seeded_state_dict, table_parts, with_jax_draws,
    write_checkpoints,
)

from ssad_tpu import cli as jcli
from ssad_tpu_torch import cli


def _common(data, models, out):
    return ["--dataset-dir", str(data), "--models-dir", str(models), "--outputs-dir", str(out),
            "--imsize", str(IMSIZE), "--batch-size", "8"]


def test_cli_evaluate_patch_level_matches_jax(fake_mvtec, tmp_path, capsys, monkeypatch):
    port_models, jax_models = write_checkpoints(tmp_path, ["bottle"], seeded_state_dict(0))
    args = ["evaluate", "--subjects", "bottle", "--patch-level"]
    assert jcli.main(args + _common(fake_mvtec, jax_models, tmp_path / "jax_out")) == 0
    want = capsys.readouterr().out.strip().splitlines()
    with_jax_draws(monkeypatch)
    assert cli.main(args + _common(fake_mvtec, port_models, tmp_path / "port_out")
                    + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out.strip().splitlines()
    assert got == want and got[0].startswith("bottle: pixel_auroc=")
    assert files_under(tmp_path / "port_out") == files_under(tmp_path / "jax_out")
    assert_tables_match(tmp_path / "port_out" / "tables", tmp_path / "jax_out" / "tables", 1e-3)


#: patch normality: 3 images × 25 windows = 75 rows → 53 train rows
SCORER_FLAGS = {"scorer-mahalanobis": ["--scorer", "mahalanobis"],
                "coreset-20": ["--coreset", "20", "--knn-k", "1"]}


@pytest.mark.parametrize("name", list(SCORER_FLAGS))
def test_cli_evaluate_patch_level_scorers_match_jax(fake_mvtec, tmp_path, capsys, monkeypatch,
                                                    name):
    port_models, jax_models = write_checkpoints(tmp_path, ["bottle"], seeded_state_dict(0))
    args = ["evaluate", "--subjects", "bottle", "--patch-level"] + SCORER_FLAGS[name]
    assert jcli.main(args + _common(fake_mvtec, jax_models, tmp_path / "jax_out")) == 0
    want = capsys.readouterr().out.strip().splitlines()
    with_jax_draws(monkeypatch)
    assert cli.main(args + _common(fake_mvtec, port_models, tmp_path / "port_out")
                    + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out.strip().splitlines()
    (got_text, got_numbers), (text, numbers) = table_parts(got[0]), table_parts(want[0])
    assert len(got) == len(want) == 1 and got_text == text
    assert text.startswith("bottle: pixel_auroc=") and len(got_numbers) == 3
    np.testing.assert_allclose(got_numbers, numbers, rtol=0, atol=1e-3 + 1e-4)
    assert_tables_match(tmp_path / "port_out" / "tables", tmp_path / "jax_out" / "tables", 1e-3)
