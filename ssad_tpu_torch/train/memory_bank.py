"""The memory bank: a fixed-capacity ring buffer of embeddings.

Counterpart of ssad_tpu/train/memory_bank.py:24-31, :81-90.  This slice
only reads a bank (from a checkpoint, for the detector's normality);
``insert`` waits for the training slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class MemoryBank(NamedTuple):
    data: torch.Tensor  # (capacity, dim)
    cursor: torch.Tensor  # scalar int32: next write slot
    count: torch.Tensor  # scalar int32: valid rows (≤ capacity)

    @property
    def capacity(self) -> int:
        return self.data.shape[0]


def newest_first(bank: MemoryBank) -> torch.Tensor:
    """Valid rows ordered newest → oldest."""
    cap, cursor = bank.capacity, int(bank.cursor)
    order = [(cursor - 1 - i) % cap for i in range(int(bank.count))]
    return bank.data[torch.tensor(order, dtype=torch.long, device=bank.data.device)]
