"""The port's Trainer end to end on the fake MVTec tree (64², batch 4, 1 + 3
epochs, one step an epoch, one validation batch): the history has the JAX
trainer's keys, the bank fills only in the fill epochs (epoch > epochs //
2), and the best-val copy follows the fine-tune cadence
(tests/test_torch_trainer_resume.py: drain and resume).  No JAX: the keys
are those of ssad_tpu/train/trainer.py:374-391."""

import pytest
import torch

from ssad_tpu_torch.config import DataConfig, ModelConfig, OptimConfig, TrainConfig
from ssad_tpu_torch.data import mvtec
from ssad_tpu_torch.train import trainer as tmod

torch.set_num_threads(1)

SIZE, BATCH = 64, 4
JAX_HISTORY_KEYS = {f"{stage}_{k}" for stage in ("projection", "fine_tune")
                    for k in ("images_per_sec", "train_loss", "train_accuracy", "val_loss",
                              "val_accuracy")}


def _cfg(root, projection_epochs=1):
    return TrainConfig(
        data=DataConfig(dataset_dir=str(root), subject="bottle", imsize=(SIZE, SIZE),
                        batch_size=BATCH, min_dataset_length=BATCH),
        model=ModelConfig(compute_dtype="float32", memory_bank_size=16),
        optim=OptimConfig(projection_epochs=projection_epochs, fine_tune_epochs=3,
                          val_batches=1, checkpoint_every_n_epochs=2),
    )


@pytest.fixture(scope="module")
def data(fake_mvtec):
    return mvtec.prepare_pretext_data(fake_mvtec, "bottle", imsize=(SIZE, SIZE))


def test_history_fill_epochs_and_best_cadence(fake_mvtec, data, monkeypatch):
    fills = []
    step = tmod.Trainer.train_step

    def spy(self, state, uploaded, dd, fill):
        fills.append((state.optimizer.stage, fill))
        return step(self, state, uploaded, dd, fill)

    monkeypatch.setattr(tmod.Trainer, "train_step", spy)
    trainer = tmod.Trainer(_cfg(fake_mvtec), data, "cpu")
    assert trainer.steps_per_epoch == 1
    result = trainer.fit(seed=0, verbose=False)
    assert set(result.history) == JAX_HISTORY_KEYS
    for key, values in result.history.items():
        assert len(values) == (1 if key.startswith("projection") else 3), key
    # only fine-tune epoch 2 (of 0..2) fills
    assert fills == [("projection", False), ("fine_tune", False), ("fine_tune", False),
                     ("fine_tune", True)]
    assert 0 <= int(result.bank.count) <= BATCH
    # the best-val copy is taken at epoch 2 of 3 only (cadence 2)
    assert result.best_val_loss == result.history["fine_tune_val_loss"][1]
    assert set(result.best_state_dict) == set(result.state_dict)


def test_stage_generators_are_fixed_per_seed_and_stage():
    a, b = tmod.stage_generator(5, 2), tmod.stage_generator(5, 2)
    assert torch.equal(torch.rand(4, generator=a), torch.rand(4, generator=b))
    assert not torch.equal(torch.rand(4, generator=tmod.stage_generator(5, 1)),
                           torch.rand(4, generator=tmod.stage_generator(5, 2)))


def test_bank_fill_keeps_the_train_mode_and_takes_accepted_rows():
    from ssad_tpu_torch.models.peranet import build_model

    model = build_model(ModelConfig(compute_dtype="float32")).train()
    emb = tmod.bank_fill_embeddings(model, torch.rand(2, SIZE, SIZE, 3))
    assert model.training and emb.shape == (2, 512) and not emb.requires_grad
    y, y_hat = torch.tensor([0, 0, 1, 0]), torch.tensor([0, 2, 1, 0])
    rows, mask = tmod.bank_fill_subset(3, y, y_hat, torch.arange(4))
    assert rows.tolist() == [0, 1, 2] and mask.tolist() == [True, False, False]
