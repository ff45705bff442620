"""``cli infer`` at image level with ``--scorer mahalanobis`` and
``--coreset`` against the JAX command on fake_mvtec's bottle, each from
its own checkpoint of the same f32 weights, the port on ``--device cpu``
with the JAX package's fit permutation and the coreset's first center
(``_torch_eval.infer_scorer_against_jax``): the same JSON line but for
the threshold and the path, and ``inference.npz`` with the same keys,
shapes and labels.  The threshold and k-NN scores are held to 1e-5
absolute (tests/test_torch_infer_cli.py's), Mahalanobis scores to 1e-4
relative: the normality is fake_mvtec's train images, 3 rows after the
split in 512 dimensions, so the shrunk covariance has a condition number
of about 2e3 and the JAX package's f32 inverse is off by about that
times f32's epsilon (measured 1.9e-5 relative; the port fits in
float64).  Patch level: tests/test_torch_scorer_infer_cli_patch.py.

The JAX package's object masks here are its OpenCV path's, which the
port computes bit for bit without OpenCV: these comparisons need
OpenCV on the machine that runs the tests (without it the JAX package
takes its numpy fallback, which the port does not compute)."""

import pytest
from _torch_eval import infer_scorer_against_jax, seeded_state_dict, write_checkpoints

#: image normality: fake_mvtec's train images, 3 train rows after the split
FLAGS = {"scorer-mahalanobis": ["--scorer", "mahalanobis"],
         "coreset": ["--knn-k", "1", "--coreset", "2"]}
#: (rtol, atol) of the threshold and the scores
TOLERANCES = {"scorer-mahalanobis": (1e-4, 0.0), "coreset": (0.0, 1e-5)}


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    return write_checkpoints(tmp_path_factory.mktemp("models"), ["bottle"], seeded_state_dict(0))


@pytest.mark.parametrize("patch", [False], ids=["image"])
@pytest.mark.parametrize("name", list(FLAGS))
def test_cli_infer_scorers_match_jax(fake_mvtec, models, tmp_path, capsys, monkeypatch, name,
                                     patch):
    infer_scorer_against_jax(fake_mvtec, models, tmp_path, capsys, monkeypatch, FLAGS[name],
                             patch, *TOLERANCES[name])
