"""The port's checkpoints: the reference layout plus the TrainConfig.

Counterpart of ssad_tpu/train/checkpoint.py.  The JAX package writes an
Orbax directory; the port writes ``<dir>/best_model.ckpt`` in the
reference Lightning layout it already reads (utils/ref_checkpoint.py:
state_dict, memory_bank rows oldest → newest, hyper_parameters) with the
TrainConfig JSON under ``train_config``, so ``export`` and the JAX
package's ``import-ckpt`` read it, and a reference checkpoint without a
TrainConfig still loads.  Orbax directories are not read: that is a
deliberate difference (the card machine has no Orbax).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import torch

from ssad_tpu_torch.config import TrainConfig
from ssad_tpu_torch.train.memory_bank import MemoryBank, newest_first
from ssad_tpu_torch.utils.ref_checkpoint import save_reference_checkpoint

CHECKPOINT_NAME = "best_model"  # the reference's file name (tools.py:304-306)


def save_checkpoint(
    outputs_dir: str | Path,
    state_dict: Dict[str, torch.Tensor],
    bank: Optional[MemoryBank],
    cfg: TrainConfig,
    name: str = CHECKPOINT_NAME,
) -> str:
    """Write ``<outputs_dir>/<name>.ckpt``; returns its path."""
    rows = None
    if bank is not None and int(bank.count) > 0:
        rows = newest_first(bank).flip(0).cpu().numpy()
    return save_reference_checkpoint(Path(outputs_dir) / f"{name}.ckpt", state_dict, rows,
                                     train_config=cfg)
