"""The MVTec readiness run of the port: ``train --dataset-dir`` composed
with ``--pretrained-backbone``, then ``evaluate``, through
``ssad_tpu_torch.cli.main`` on the CPU (the counterpart of
tests/test_mvtec_readiness.py).

* The weight file is a seeded torchvision-layout ResNet-18 ``.pth`` with
  non-trivial BatchNorm statistics (test_torch_train_checkpoint.py's
  ``_torchvision_state_dict`` with running means N(0, 1), as the JAX test's
  ``randn``, and variances in [0.5, 1.5]); the tree is conftest's
  ``fake_mvtec``.  At that helper's default N(0, 0.1) the two train steps'
  batch statistics (momentum 0.9) outweigh the file's: bn1's correlation
  reads 0.34 (0.92 at N(0, 1)), so the check below needs the larger means.
* ``train`` (64², batch 4, 1 + 1 epochs) writes the checkpoint; its conv1
  correlates above 0.8 with ``convert_resnet_state_dict``'s conv1 of the
  file (the projection stage freezes the backbone; one fine-tune step moves
  it a little), and the file's ``bn1.running_mean`` is found among the
  checkpoint's backbone running means at a correlation above 0.8 (a
  random init's are 0: a loader that drops the statistics fails here).
* ``evaluate --subjects bottle`` prints ``image_auroc=`` and writes
  ``tables/markdown/image_all_scores.md`` naming bottle.
* Against JAX: the model ``train`` starts from (``Trainer.init_state``,
  f32) gives the JAX package's model after its ``load_resnet18_into`` of
  the same file the same eval embeddings within 1e-5, before any step.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import jax_variables, seeded
from test_torch_train_checkpoint import _torchvision_state_dict

from ssad_tpu.utils.torch_weights import load_resnet18_into as jax_load_resnet18_into
from ssad_tpu_torch import cli
from ssad_tpu_torch.config import DataConfig, ModelConfig, TrainConfig
from ssad_tpu_torch.data import mvtec
from ssad_tpu_torch.train.trainer import Trainer
from ssad_tpu_torch.utils.device import resolve_device
from ssad_tpu_torch.utils.ref_checkpoint import load_checkpoint
from ssad_tpu_torch.utils.torch_weights import convert_resnet_state_dict

torch.set_num_threads(1)

CORR = 0.8


@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    sd = _torchvision_state_dict(seed=7, mean_std=1.0)
    path = tmp_path_factory.mktemp("weights") / "resnet18.pth"
    torch.save(sd, path)
    return path


def _corr(a, b) -> float:
    return float(np.corrcoef(np.ravel(a), np.ravel(b))[0, 1])


def test_pretrained_backbone_composes_with_dataset_dir(fake_mvtec, pth, tmp_path, capsys):
    models = tmp_path / "models"
    assert cli.main([
        "train", "--dataset-dir", str(fake_mvtec), "--subject", "bottle", "--imsize", "64",
        "--batch-size", "4", "--min-dataset-length", "4", "--projection-epochs", "1",
        "--fine-tune-epochs", "1", "--pretrained-backbone", str(pth),
        "--outputs-dir", str(models), "--quiet", "--device", "cpu",
    ]) == 0
    ckpt = models / "bottle" / "best_model.ckpt"
    assert ckpt.is_file()
    state, _, _, cfg = load_checkpoint(ckpt)
    assert cfg.model.pretrained_backbone == str(pth)
    want = convert_resnet_state_dict(torch.load(pth, weights_only=True))
    assert _corr(state["feature_extractor.conv1.weight"], want["conv1.weight"]) > CORR
    mean = want["bn1.running_mean"]
    found = [k for k, v in state.items()
             if k.startswith("feature_extractor.") and k.endswith("running_mean")
             and v.shape == mean.shape and _corr(v, mean) > CORR]
    assert found, "the file's bn1.running_mean is in no BatchNorm of the checkpoint"

    out = tmp_path / "eval"
    capsys.readouterr()
    assert cli.main(["evaluate", "--dataset-dir", str(fake_mvtec), "--models-dir", str(models),
                     "--subjects", "bottle", "--imsize", "64", "--outputs-dir", str(out),
                     "--device", "cpu"]) == 0
    assert "image_auroc=" in capsys.readouterr().out
    table = out / "tables" / "markdown" / "image_all_scores.md"
    assert table.is_file() and "bottle" in table.read_text()


def test_the_trainers_start_is_jaxs_load_of_the_file(fake_mvtec, pth):
    cfg = TrainConfig(
        data=DataConfig(dataset_dir=str(fake_mvtec), subject="bottle", imsize=(64, 64),
                        batch_size=4, min_dataset_length=4),
        model=ModelConfig(compute_dtype="float32", pretrained_backbone=str(pth)))
    data = mvtec.prepare_pretext_data(fake_mvtec, "bottle", imsize=cfg.data.imsize,
                                      val_fraction=cfg.data.train_val_split, seed=0)
    trainer = Trainer(cfg, data, resolve_device("cpu"))
    trainer.init_state("projection")
    # the JAX side: the port's head through the bridge, then JAX's own
    # loader of the file over the whole backbone
    jmodel, params, stats = jax_variables(trainer.model.state_dict(), "float32")
    params, stats = jax_load_resnet18_into(params, str(pth), stats)
    x = seeded((2, 64, 64, 3), 5)
    ref = jmodel.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = trainer.model.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got["latent_space"].numpy(), np.asarray(ref["latent_space"]),
                               rtol=1e-5, atol=1e-5)
