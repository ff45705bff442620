"""``cli train`` and ``cli import-ckpt`` of the port on the CPU.

* ``train --device cpu`` end to end on the fake MVTec tree (64², batch 4,
  1 + 3 epochs) writes best_model.ckpt with its TrainConfig, history.json
  with the JAX command's keys, and both history PNGs.
* ``import-ckpt``: a reference Lightning checkpoint becomes the port's,
  with a TrainConfig carrying --subject and --imsize.
(tests/test_torch_train_preempt.py: SIGTERM with --resume-dir.)
"""

import json

import numpy as np
import torch
from PIL import Image
from test_ref_checkpoint import lightning_checkpoint
from test_torch_trainer import JAX_HISTORY_KEYS

from ssad_tpu_torch import cli
from ssad_tpu_torch.train.memory_bank import newest_first
from ssad_tpu_torch.utils.ref_checkpoint import load_checkpoint

torch.set_num_threads(1)



def _train_args(fake_mvtec, out, fine_tune_epochs=3):
    return ["train", "--dataset-dir", str(fake_mvtec), "--subject", "bottle",
            "--outputs-dir", str(out), "--imsize", "64", "--batch-size", "4",
            "--projection-epochs", "1", "--fine-tune-epochs", str(fine_tune_epochs),
            "--min-dataset-length", "4", "--device", "cpu"]


def test_cli_train_writes_the_checkpoint_history_and_plots(fake_mvtec, tmp_path, capsys):
    assert cli.main(_train_args(fake_mvtec, tmp_path)) == 0
    out = tmp_path / "bottle"
    assert f"checkpoint: {out / 'best_model.ckpt'}" in capsys.readouterr().out
    _, _, mcfg, cfg = load_checkpoint(out / "best_model.ckpt")
    assert (cfg.data.subject, cfg.data.imsize, cfg.data.batch_size) == ("bottle", (64, 64), 4)
    assert mcfg == cfg.model and cfg.optim.fine_tune_epochs == 3
    history = json.loads((out / "history.json").read_text())
    assert set(history) == JAX_HISTORY_KEYS
    assert all(np.isfinite(history[k]).all() for k in history)
    for mode in ("training", "fine_tune"):
        with Image.open(out / f"{mode}_history.png") as png:
            assert png.size == (960, 320)


def test_cli_import_ckpt(tmp_path, capsys):
    torch.save(lightning_checkpoint(bank_rows=7), tmp_path / "ref.ckpt")
    assert cli.main(["import-ckpt", "--ckpt", str(tmp_path / "ref.ckpt"), "--models-dir",
                     str(tmp_path / "m"), "--subject", "hazelnut", "--imsize", "128"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["bank_rows"] == 7 and summary["subject"] == "hazelnut"
    sd, bank, _, cfg = load_checkpoint(tmp_path / "m" / "hazelnut" / "best_model.ckpt")
    assert (cfg.data.subject, cfg.data.imsize) == ("hazelnut", (128, 128))
    ref = lightning_checkpoint(bank_rows=7)
    assert torch.equal(newest_first(bank), ref["memory_bank"].flip(0))
    assert all(torch.equal(sd[k], v) for k, v in ref["state_dict"].items())
