"""``python -m ssad_tpu_torch.cli evaluate`` at image level against the
JAX command on fake_mvtec's bottle (tests/conftest.py), each from its own
checkpoint of the same f32 weights (``_torch_eval.write_checkpoints``),
the port on ``--device cpu`` with the JAX package's fit permutation and
artificial draws (``_torch_eval.with_jax_draws``).  The same stdout line
(image AUROC and F1, printed to 4 decimals), every file the JAX command
writes but ``bottle_tsne.png`` (slice 6b), and the tables with the same
labels and numbers within 2e-3 (the artificial table's good-vs-defect
AUROC: tests/test_torch_evaluator.py says why; measured 8.0e-4).  Patch
level and ``infer``: tests/test_torch_eval_cli_patch.py."""

from pathlib import Path

import numpy as np
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
    from ssad_tpu.evaluation import visualization as jvis

    port_models, jax_models = write_checkpoints(tmp_path, ["bottle"], seeded_state_dict(0))
    # the t-SNE figure, which the port does not draw yet (slice 6b), stays
    # an empty file on the JAX side: it is left out of the comparison
    monkeypatch.setattr(jvis, "plot_tsne", lambda emb, labels, path, title, name, seed=0:
                        jvis.save_image(np.zeros((1, 1, 3), np.uint8), Path(path) / name))
    assert jcli.main(_args(fake_mvtec, jax_models, tmp_path / "jax_out")) == 0
    want = capsys.readouterr().out.strip().splitlines()
    with_jax_draws(monkeypatch)
    assert cli.main(_args(fake_mvtec, port_models, tmp_path / "port_out")
                    + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out.strip().splitlines()
    assert got == want and got[0].startswith("bottle: image_auroc=")
    assert files_under(tmp_path / "port_out") == \
        files_under(tmp_path / "jax_out") - {"bottle/bottle_tsne.png"}
    assert_tables_match(tmp_path / "port_out" / "tables", tmp_path / "jax_out" / "tables", 2e-3)


@pytest.mark.parametrize("flags,slice_no", [
    (["--scorer", "mahalanobis"], "slice 7"), (["--coreset", "10"], "slice 7"),
    (["--data-shards", "2"], "slice 9"), (["--category-shards", "2"], "slice 9"),
])
def test_unported_flags_are_refused(fake_mvtec, tmp_path, capsys, flags, slice_no):
    assert cli.main(_args(fake_mvtec, tmp_path, tmp_path / "out") + flags
                    + ["--device", "cpu"]) == 2
    assert slice_no in capsys.readouterr().err
