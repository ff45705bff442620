"""A training run drained at an epoch boundary (``stop_requested``) and
resumed from its snapshot ends with the same parameters, statistics, best
copy, bank and history as an uninterrupted run, bit for bit on the CPU;
``TrainingPreempted`` carries the stage and epoch.  Setup:
tests/test_torch_trainer.py."""

import pytest
import torch
from test_torch_trainer import SIZE, _cfg

from ssad_tpu_torch.data import mvtec
from ssad_tpu_torch.train import trainer as tmod

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def data(fake_mvtec):
    return mvtec.prepare_pretext_data(fake_mvtec, "bottle", imsize=(SIZE, SIZE))


def _same(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("projection_epochs, stage", [(1, "fine_tune"), (2, "projection")])
def test_a_resumed_run_equals_an_uninterrupted_one(fake_mvtec, data, tmp_path,
                                                   projection_epochs, stage):
    """A drain after the first epoch at which one is honoured (not a
    stage's last epoch): fine-tune epoch 0 with one projection epoch,
    projection epoch 0 with two."""
    cfg = _cfg(fake_mvtec, projection_epochs)
    whole = tmod.Trainer(cfg, data, "cpu").fit(seed=3, verbose=False)
    with pytest.raises(tmod.TrainingPreempted) as stop:
        tmod.Trainer(cfg, data, "cpu").fit(seed=3, verbose=False, resume_dir=tmp_path,
                                           stop_requested=lambda: True)
    assert (stop.value.stage, stop.value.epoch) == (stage, 0)
    assert tmod.Trainer.snapshot_path(tmp_path).exists()
    resumed = tmod.Trainer(cfg, data, "cpu").fit(seed=3, verbose=False, resume_dir=tmp_path)
    _same(whole.state_dict, resumed.state_dict)
    _same(whole.best_state_dict, resumed.best_state_dict)
    for field in whole.bank._fields:
        assert torch.equal(getattr(whole.bank, field), getattr(resumed.bank, field)), field
    for key in whole.history:
        if not key.endswith("images_per_sec"):
            assert whole.history[key] == resumed.history[key], key
