"""The port's checkpoint (the reference layout plus the TrainConfig), the
TrainConfig JSON shared with the JAX package, ``export`` reading imsize
and subject from the checkpoint, and the torchvision backbone loader.

* save → load round-trips the state dict, the bank (oldest → newest on
  disk, the same newest-first view back) and the TrainConfig; the JAX
  package's reference-checkpoint reader reads the port's file.
* A ``train_config.json`` written by the JAX TrainConfig reads in the
  port and back to the same JSON.
* ``export`` of the port's own checkpoint takes imsize and subject from
  its TrainConfig (an explicit argument still wins); a reference
  checkpoint without one exports as before (DataConfig's 256, no subject).
* ``--pretrained-backbone``: a seeded random torchvision-layout ``.pth``
  (with ``fc.*``) goes through the JAX ``load_resnet18_into`` and the
  port's loader; the eval-mode embeddings are equal to 1e-5 at f32.  A
  wrong key or shape raises.
"""

import dataclasses
import json

import _torch_card_fixtures as fx
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import jax_variables, seeded
from test_ref_checkpoint import reference_state_dict

from ssad_tpu.config import DataConfig as JDataConfig
from ssad_tpu.config import ModelConfig as JModelConfig
from ssad_tpu.config import OptimConfig as JOptimConfig
from ssad_tpu.config import TrainConfig as JTrainConfig
from ssad_tpu.train.memory_bank import newest_first as jax_newest_first
from ssad_tpu.utils import ref_checkpoint as jref
from ssad_tpu.utils.torch_weights import load_resnet18_into as jax_load_resnet18_into
from ssad_tpu_torch.config import DataConfig, ModelConfig, TrainConfig
from ssad_tpu_torch.models.peranet import build_model
from ssad_tpu_torch.serving.export import export_checkpoint, read_artifact
from ssad_tpu_torch.train.checkpoint import save_checkpoint
from ssad_tpu_torch.train.memory_bank import init_bank, insert, newest_first
from ssad_tpu_torch.utils.ref_checkpoint import load_checkpoint, save_reference_checkpoint
from ssad_tpu_torch.utils.torch_weights import load_resnet18_into

torch.set_num_threads(1)


def _bank(rows=20, capacity=16, seed=0):
    """A ring that has wrapped: ``rows`` accepted into ``capacity``."""
    emb = torch.from_numpy(np.random.default_rng(seed).normal(size=(rows, 512)).astype(np.float32))
    return insert(init_bank(capacity, 512), emb, torch.ones(rows, dtype=torch.bool))


def _train_cfg(subject="carpet", imsize=64):
    return TrainConfig(data=DataConfig(subject=subject, imsize=(imsize, imsize)),
                       model=ModelConfig(compute_dtype="float32", memory_bank_size=16))


def test_save_load_round_trip(tmp_path):
    sd, bank, cfg = reference_state_dict(), _bank(), _train_cfg()
    path = save_checkpoint(tmp_path / "carpet", sd, bank, cfg)
    assert path.endswith("carpet/best_model.ckpt")
    sd2, bank2, mcfg, cfg2 = load_checkpoint(path)
    assert cfg2 == cfg and mcfg == cfg.model
    assert set(sd2) == set(sd) and all(torch.equal(sd2[k], sd[k]) for k in sd)
    assert int(bank2.count) == 16
    assert torch.equal(newest_first(bank2), newest_first(bank))
    # the JAX package reads the port's file as a reference checkpoint
    _, _, jbank, jcfg = jref.load_reference_checkpoint(path)
    assert jcfg.memory_bank_size == 16
    np.testing.assert_array_equal(jax_newest_first(jbank), newest_first(bank).numpy())


def test_train_config_json_round_trips_with_jax(tmp_path):
    theirs = JTrainConfig(
        data=JDataConfig(dataset_dir="/d", subject="screw", imsize=(128, 128), batch_size=12,
                         min_dataset_length=50, patch_localization=True),
        model=JModelConfig(bank_fill_rows=32, stem_s2d=True, pretrained_backbone="/w.pth"),
        optim=JOptimConfig(fine_tune_epochs=7, val_batches=2), seed=9)
    (tmp_path / "train_config.json").write_text(theirs.to_json())
    ours = TrainConfig.from_json((tmp_path / "train_config.json").read_text())
    assert ours.data.imsize == (128, 128) and ours.model.stem_s2d and ours.seed == 9
    assert json.loads(ours.to_json()) == json.loads(theirs.to_json())
    assert JTrainConfig.from_json(ours.to_json()) == theirs
    assert dataclasses.asdict(TrainConfig()) == dataclasses.asdict(JTrainConfig())


def test_export_reads_imsize_and_subject_from_the_train_config(tmp_path):
    path = save_checkpoint(tmp_path / "m" / "carpet", reference_state_dict(), _bank(),
                           _train_cfg("carpet", 64))
    meta, _ = read_artifact(export_checkpoint(path, tmp_path / "a.ssadpt", device="cpu"))
    assert (meta["imsize"], meta["subject"]) == ([64, 64], "carpet")
    meta, _ = read_artifact(export_checkpoint(path, tmp_path / "b.ssadpt", imsize=(96, 96),
                                              subject="x", device="cpu"))
    assert (meta["imsize"], meta["subject"]) == ([96, 96], "x")  # explicit wins


def test_a_reference_checkpoint_without_train_config_exports_as_before(tmp_path):
    rows = newest_first(_bank()).flip(0).numpy()
    path = save_reference_checkpoint(tmp_path / "best_model.ckpt", reference_state_dict(), rows,
                                     ModelConfig(compute_dtype="float32", memory_bank_size=16))
    assert load_checkpoint(path)[3] is None
    meta, payload = read_artifact(export_checkpoint(path, tmp_path / "a.ssadpt", device="cpu"))
    assert meta["imsize"] == list(DataConfig().imsize) and "subject" not in meta
    assert payload["bank"].shape[0] == 16 - round(0.3 * 16)


def _torchvision_state_dict(seed=0, mean_std=0.1):
    """Seeded random weights with torchvision resnet18's keys and shapes;
    running means N(0, ``mean_std``) (the fixtures' weights, which
    chip_smoke.py phase 13 loads at ``mean_std`` 1)."""
    return fx.torchvision_state_dict(seed, mean_std)


def test_pretrained_backbone_matches_jax(tmp_path):
    pth = tmp_path / "resnet18.pth"
    torch.save(_torchvision_state_dict(), pth)
    head = reference_state_dict(seed=1)
    jmodel, params, stats = jax_variables(head, "float32")
    params, stats = jax_load_resnet18_into(params, str(pth), stats)
    x = seeded((2, 64, 64, 3), 4)
    ref = jmodel.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train=False)
    model = build_model(ModelConfig(compute_dtype="float32"))
    model.load_state_dict(head, strict=True)
    load_resnet18_into(model, pth)
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(out["latent_space"].numpy(), np.asarray(ref["latent_space"]),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(model.feature_extractor.bn1.running_var,
                       torch.load(pth)["bn1.running_var"])


@pytest.mark.parametrize("fault", ["missing", "shape"])
def test_pretrained_backbone_rejects_a_wrong_file(tmp_path, fault):
    sd = _torchvision_state_dict()
    if fault == "missing":
        del sd["layer3.1.conv2.weight"]
    else:
        sd["conv1.weight"] = torch.zeros(64, 3, 5, 5)
    torch.save(sd, tmp_path / "bad.pth")
    with pytest.raises(ValueError, match="layer3.1.conv2.weight|conv1.weight"):
        load_resnet18_into(build_model(ModelConfig()), tmp_path / "bad.pth")
