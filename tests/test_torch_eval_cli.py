"""``python -m ssad_tpu_torch.cli evaluate`` at image level against the
JAX command on fake_mvtec's bottle (tests/conftest.py), each from its own
checkpoint of the same f32 weights (``_torch_eval.write_checkpoints``),
the port on ``--device cpu`` with the JAX package's fit permutation and
artificial draws (``_torch_eval.with_jax_draws``).  The same stdout line
(image AUROC and F1, printed to 4 decimals), every file the JAX command
writes (``bottle_tsne.png`` from each package's own t-SNE), and the tables with the same
labels and numbers within 2e-3 (the artificial table's good-vs-defect
AUROC: tests/test_torch_evaluator.py says why; measured 8.0e-4).  Patch
level and ``infer``: tests/test_torch_eval_cli_patch.py.  ``--scorer
mahalanobis`` and ``--coreset`` run and write the same files (their JAX
parity: tests/test_torch_scorer_cli*.py); sharding above 1 is refused."""

import pytest
from _torch_port import jax_masks_on_the_numpy_path  # noqa: F401  (autouse fixture)
from _torch_eval import (
    IMSIZE, assert_tables_match, files_under, seeded_state_dict, with_jax_draws,
    write_checkpoints,
)

from ssad_tpu import cli as jcli
from ssad_tpu_torch import cli


def _args(data, models, out):
    return ["evaluate", "--dataset-dir", str(data), "--models-dir", str(models),
            "--outputs-dir", str(out), "--subjects", "bottle", "--imsize", str(IMSIZE),
            "--batch-size", "8"]


def test_cli_evaluate_image_level_matches_jax(fake_mvtec, tmp_path, capsys, monkeypatch):
    port_models, jax_models = write_checkpoints(tmp_path, ["bottle"], seeded_state_dict(0))
    assert jcli.main(_args(fake_mvtec, jax_models, tmp_path / "jax_out")) == 0
    want = capsys.readouterr().out.strip().splitlines()
    with_jax_draws(monkeypatch)
    assert cli.main(_args(fake_mvtec, port_models, tmp_path / "port_out")
                    + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out.strip().splitlines()
    assert got == want and got[0].startswith("bottle: image_auroc=")
    assert files_under(tmp_path / "port_out") == files_under(tmp_path / "jax_out")
    assert "bottle/bottle_tsne.png" in files_under(tmp_path / "port_out")
    assert_tables_match(tmp_path / "port_out" / "tables", tmp_path / "jax_out" / "tables", 2e-3)


@pytest.mark.parametrize("flags,note", [
    (["--scorer", "mahalanobis"], None), (["--coreset", "10"], "consider --knn-k 1"),
], ids=["scorer-mahalanobis", "coreset-10"])
def test_scorer_flags_run(fake_mvtec, tmp_path, capsys, flags, note):
    """The scorer flags (refused before the scorers were ported) run: one
    score line, the image-level files, and the score table holding the
    printed numbers."""
    models, _ = write_checkpoints(tmp_path, ["bottle"], seeded_state_dict(0))
    out = tmp_path / "out"
    assert cli.main(_args(fake_mvtec, models, out) + flags + ["--device", "cpu"]) == 0
    printed = capsys.readouterr()
    (line,) = printed.out.strip().splitlines()
    auroc, f1 = (float(part.split("=")[1]) for part in line.split(": ")[1].split())
    assert (note in printed.err) if note else printed.err == ""
    assert {"bottle/bottle_image_roc.png", "bottle/bottle_artificial_report.txt",
            "tables/csv/image_all_scores.csv", "tables/markdown/image_all_scores.md"} <= \
        files_under(out)
    row = (out / "tables" / "csv" / "image_all_scores.csv").read_text().splitlines()[1]
    assert row == f"bottle,{auroc:.4f},{f1:.4f}"


@pytest.mark.parametrize("flags,slice_no", [
    pytest.param(["--data-shards", "2"], "slice 9", id="flags2-slice 9"),
    pytest.param(["--category-shards", "2"], "slice 9", id="flags3-slice 9"),
])
def test_unported_flags_are_refused(fake_mvtec, tmp_path, capsys, flags, slice_no):
    assert cli.main(_args(fake_mvtec, tmp_path, tmp_path / "out") + flags
                    + ["--device", "cpu"]) == 2
    assert slice_no in capsys.readouterr().err
