"""``cli export --dtype --validate`` and ``cli evaluate-artifact`` of the
port against the JAX commands (ssad_tpu/serving/cli.py:78-130, :583-657)
on fake_mvtec's bottle: one seeded f32 PeraNet and a 40-row bank written
as a checkpoint of each package, image mode, batch 2, the port on
``--device cpu`` with the JAX fit permutation (``_torch_eval.
with_jax_draws``), so both artifacts hold the same bank and threshold.

Held: the same JSON keys; ``--validate`` finite, the same label
agreement, each drift under the JAX test's 0.05 and the two drifts within
1e-5 of each other (the int8 scores of the two packages agree to 6e-8,
tests/test_torch_quant.py); ``evaluate-artifact`` the same subject, mode,
scorer, test count and metrics (printed to 4 decimals), the baked
threshold within 1e-6.  Deliberate difference: the port's ``dtype`` field
is the artifact's ``weights_dtype``; the JAX command reads a ``dtype`` key
its header does not have and prints null.

Patch mode: tests/test_torch_serving_extras_patch_cli.py; a bfloat16
patch artifact: tests/test_torch_serving_extras.py."""

import json

import numpy as np
import pytest
import torch
from _torch_eval import IMSIZE, seeded_state_dict, with_jax_draws
from _torch_port import jax_masks_on_the_numpy_path  # noqa: F401  (autouse fixture)
from _torch_port import jax_variables

from ssad_tpu_torch import cli

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """(port models dir, JAX models dir), each holding bottle's checkpoint."""
    import jax.numpy as jnp

    from ssad_tpu import config as jconfig
    from ssad_tpu.train import checkpoint as jckpt
    from ssad_tpu.train.memory_bank import MemoryBank as JBank
    from ssad_tpu_torch.config import DataConfig, ModelConfig, TrainConfig
    from ssad_tpu_torch.train.checkpoint import save_checkpoint
    from ssad_tpu_torch.train.memory_bank import MemoryBank

    root = tmp_path_factory.mktemp("extras_cli")
    sd = seeded_state_dict(0)
    rows = np.random.default_rng(1).standard_normal((40, 512)).astype(np.float32)
    save_checkpoint(root / "port" / "bottle", sd,
                    MemoryBank(torch.from_numpy(rows), torch.tensor(0), torch.tensor(40)),
                    TrainConfig(data=DataConfig(subject="bottle", imsize=(IMSIZE, IMSIZE)),
                                model=ModelConfig(compute_dtype="float32")))
    _, params, stats = jax_variables(sd, "float32")
    jckpt.save_checkpoint(
        root / "jax" / "bottle", params, stats,
        JBank(data=jnp.asarray(rows), cursor=jnp.zeros((), jnp.int32),
              count=jnp.asarray(40, jnp.int32)),
        jconfig.TrainConfig(data=jconfig.DataConfig(subject="bottle", imsize=(IMSIZE, IMSIZE)),
                            model=jconfig.ModelConfig(compute_dtype="float32")))
    return root / "port", root / "jax"


def _last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_export_validate_and_evaluate_artifact_match_jax(models, fake_mvtec, tmp_path,
                                                          capsys, monkeypatch):
    from ssad_tpu import cli as jcli

    port_models, jax_models = models

    def export(models_dir, out):
        return ["export", "--models-dir", str(models_dir), "--subject", "bottle", "--mode",
                "image", "--batch", "2", "--dtype", "int8", "--validate", "--out", str(out)]

    assert jcli.main(export(jax_models, tmp_path / "j.ssadexp")) == 0
    want = _last_json(capsys)
    with_jax_draws(monkeypatch)
    assert cli.main(export(port_models, tmp_path / "p.ssadpt") + ["--device", "cpu"]) == 0
    got = _last_json(capsys)
    assert set(got) == set(want) and got["mode"] == want["mode"] == "image"
    gv, wv = got["validation"], want["validation"]
    assert set(gv) == set(wv) == {"finite", "max_abs_score_drift", "label_agreement"}
    assert gv["finite"] is wv["finite"] is True
    assert gv["label_agreement"] == wv["label_agreement"]
    assert gv["max_abs_score_drift"] < 0.05 and wv["max_abs_score_drift"] < 0.05
    assert abs(gv["max_abs_score_drift"] - wv["max_abs_score_drift"]) <= 1e-5
    assert not (tmp_path / "p.float_ref.ssadpt").exists()
    assert got["bytes"] < 0.45 * 4 * sum(v.numel() for v in seeded_state_dict(0).values())

    assert jcli.main(["evaluate-artifact", "--artifact", str(tmp_path / "j.ssadexp"),
                      "--dataset-dir", str(fake_mvtec)]) == 0
    want = _last_json(capsys)
    assert cli.main(["evaluate-artifact", "--artifact", str(tmp_path / "p.ssadpt"),
                     "--dataset-dir", str(fake_mvtec), "--device", "cpu"]) == 0
    got = _last_json(capsys)
    assert set(got) == set(want)
    assert (got["dtype"], want["dtype"]) == ("int8", None)
    for key in ("subject", "mode", "scorer", "n_test", "image_auroc", "f1_optimal",
                "f1_at_baked_threshold", "served_anomaly_rate"):
        assert got[key] == want[key], key
    assert abs(got["baked_threshold"] - want["baked_threshold"]) <= 1e-6


