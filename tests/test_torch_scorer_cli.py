"""``cli evaluate --scorer mahalanobis`` and ``--coreset`` at image level
against the JAX command on fake_mvtec's bottle, each from its own
checkpoint of the same f32 weights, the port on ``--device cpu`` with the
JAX package's fit permutation and the coreset's first center
(``_torch_eval.with_jax_draws``): the same stdout line (image AUROC and
F1 to 4 decimals) and the image score tables within 1e-3 (the scores
agree to 2e-5 relative: tests/test_torch_scorer_infer_cli.py says why).
The synthetic pretext report, which no scorer reaches, is left out on
both sides (tests/test_torch_eval_cli.py holds it).  Patch level:
tests/test_torch_eval_cli_patch.py; ``infer``:
tests/test_torch_scorer_infer_cli.py.

The JAX package's object masks here are its OpenCV path's, which the
port computes bit for bit without OpenCV: these comparisons need
OpenCV on the machine that runs the tests (without it the JAX package
takes its numpy fallback, which the port does not compute)."""

import functools

import pytest
from _torch_eval import (
    IMSIZE, assert_tables_match, seeded_state_dict, with_jax_draws, write_checkpoints,
)

from ssad_tpu import cli as jcli
from ssad_tpu_torch import cli

#: the normality is fake_mvtec's train images (no bank in the checkpoint):
#: a coreset of 2 of the fit's 3 train rows, scored with k = 1
FLAGS = {"scorer-mahalanobis": ["--scorer", "mahalanobis"],
         "coreset-2": ["--coreset", "2", "--knn-k", "1"]}


def _args(data, models, out):
    return ["evaluate", "--dataset-dir", str(data), "--models-dir", str(models),
            "--outputs-dir", str(out), "--subjects", "bottle", "--imsize", str(IMSIZE),
            "--batch-size", "8"]


def without_artificial(monkeypatch):
    """Both evaluators skip the synthetic pretext batches."""
    from ssad_tpu.evaluation import evaluator as jevaluator
    from ssad_tpu_torch.evaluation import evaluator

    for module in (jevaluator, evaluator):
        monkeypatch.setattr(module, "evaluate_category", functools.partial(
            module.evaluate_category, with_artificial=False))


@pytest.mark.parametrize("name", list(FLAGS))
def test_cli_evaluate_scorers_match_jax(fake_mvtec, tmp_path, capsys, monkeypatch, name):
    from ssad_tpu.evaluation import visualization as jvis

    port_models, jax_models = write_checkpoints(tmp_path, ["bottle"], seeded_state_dict(0))
    without_artificial(monkeypatch)
    monkeypatch.setattr(jvis, "plot_tsne", lambda *a, **kw: None)  # slice 6b
    assert jcli.main(_args(fake_mvtec, jax_models, tmp_path / "jax_out") + FLAGS[name]) == 0
    want = capsys.readouterr().out.strip().splitlines()
    with_jax_draws(monkeypatch)
    assert cli.main(_args(fake_mvtec, port_models, tmp_path / "port_out") + FLAGS[name]
                    + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out.strip().splitlines()
    assert got == want and got[0].startswith("bottle: image_auroc=")
    assert_tables_match(tmp_path / "port_out" / "tables", tmp_path / "jax_out" / "tables", 1e-3)
