"""``python -m ssad_tpu_torch.cli infer`` (image and patch level)
against the JAX command on fake_mvtec's bottle, each from its own
checkpoint of the same f32 weights, the port on ``--device cpu`` with the
JAX fit permutation: the same JSON line but for the threshold and the
path, the threshold within the path's tolerance (1e-5 image, rtol 5e-3 /
atol 1e-4 patch: tests/test_torch_eval_inference.py), and
``inference.npz`` with the JAX keys and shapes, labels equal and the
anomaly scores or maps within the same tolerance."""

import json

import numpy as np
import pytest
from _torch_port import jax_masks_on_the_numpy_path  # noqa: F401  (autouse fixture)
from _torch_eval import IMSIZE, seeded_state_dict, with_jax_draws, write_checkpoints

from ssad_tpu import cli as jcli
from ssad_tpu_torch import cli


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    return write_checkpoints(tmp_path_factory.mktemp("models"), ["bottle"], seeded_state_dict(0))


def _common(data, models, out):
    return ["--dataset-dir", str(data), "--models-dir", str(models), "--outputs-dir", str(out),
            "--imsize", str(IMSIZE), "--batch-size", "8"]


@pytest.mark.parametrize("patch", [False, True])
def test_cli_infer_matches_jax(fake_mvtec, models, tmp_path, capsys, monkeypatch, patch):
    port_models, jax_models = models
    args = ["infer", "--subject", "bottle"] + (["--patch-level"] if patch else [])
    assert jcli.main(args + _common(fake_mvtec, jax_models, tmp_path / "jax")) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with_jax_draws(monkeypatch)
    assert cli.main(args + _common(fake_mvtec, port_models, tmp_path / "port")
                    + ["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    got = json.loads(lines[0])
    rtol, atol = (5e-3, 1e-4) if patch else (0.0, 1e-5)
    threshold = want.pop("threshold")
    assert abs(got.pop("threshold") - threshold) <= atol + rtol * abs(threshold)
    assert got.pop("outputs").endswith("bottle/inference.npz")
    want.pop("outputs")
    assert got == want == {"subject": "bottle", "mode": "patch" if patch else "image", "n": 4
                           if not patch else 4 * 25}
    with np.load(tmp_path / "port" / "bottle" / "inference.npz") as a, \
            np.load(tmp_path / "jax" / "bottle" / "inference.npz") as b:
        assert sorted(a.files) == sorted(b.files) == ["anomaly", "threshold", "y_hat", "y_true"]
        for k in a.files:
            assert a[k].shape == b[k].shape, k
        assert a["anomaly"].shape == ((4, IMSIZE, IMSIZE) if patch else (4,))
        assert np.array_equal(a["y_true"], b["y_true"]) and np.array_equal(a["y_hat"], b["y_hat"])
        np.testing.assert_allclose(a["anomaly"], b["anomaly"], rtol=rtol, atol=atol)
