"""``cli infer --patch-level`` with ``--scorer mahalanobis`` and
``--coreset`` against the JAX command on fake_mvtec's bottle
(``_torch_eval.infer_scorer_against_jax``, as
tests/test_torch_scorer_infer_cli.py does at image level).  The threshold
and maps are held to the patch path's rtol 5e-3 / atol 1e-4
(tests/test_torch_infer_cli.py's): the stem rounds to bf16 in another
order on each side.

The JAX package's object masks here are its OpenCV path's, which the
port computes bit for bit without OpenCV: these comparisons need
OpenCV on the machine that runs the tests (without it the JAX package
takes its numpy fallback, which the port does not compute)."""

import pytest
from _torch_eval import infer_scorer_against_jax, seeded_state_dict, write_checkpoints

#: patch normality: 3 images × 25 windows = 75 rows → 53 train rows
FLAGS = {"scorer-mahalanobis": ["--scorer", "mahalanobis"],
         "coreset": ["--knn-k", "1", "--coreset", "20"]}


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    return write_checkpoints(tmp_path_factory.mktemp("models"), ["bottle"], seeded_state_dict(0))


@pytest.mark.parametrize("patch", [True], ids=["patch"])
@pytest.mark.parametrize("name", list(FLAGS))
def test_cli_infer_scorers_match_jax(fake_mvtec, models, tmp_path, capsys, monkeypatch, name,
                                     patch):
    infer_scorer_against_jax(fake_mvtec, models, tmp_path, capsys, monkeypatch, FLAGS[name],
                             patch, 5e-3, 1e-4)
