"""The memory bank: a fixed-capacity ring buffer of embeddings on the device.

Counterpart of ssad_tpu/train/memory_bank.py.  ``insert`` writes the
accepted rows of a batch at ring slots (cursor + rank) mod capacity, rank
being the row's place among the accepted ones (an exclusive prefix sum),
and keeps only the last ``capacity`` accepted rows when more arrive in one
call (the newest wins, as in a sequential ring).  The surviving rows have
unique slots, so one ``index_copy_`` writes them; the JAX package's
one-hot matmul scatter is a TPU workaround.  cursor and count stay device
tensors: an insert never reads the device from the host.
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


def init_bank(capacity: int, dim: int, device=None, dtype=torch.float32) -> MemoryBank:
    return MemoryBank(
        data=torch.zeros((capacity, dim), dtype=dtype, device=device),
        cursor=torch.zeros((), dtype=torch.int32, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device),
    )


def insert(bank: MemoryBank, embeddings: torch.Tensor, mask: torch.Tensor) -> MemoryBank:
    """A new bank with ``embeddings[i]`` written where ``mask[i]``, in batch
    order (the input bank is not modified)."""
    cap, dim = bank.data.shape
    accepted = mask.to(torch.int32)
    rank = torch.cumsum(accepted, 0, dtype=torch.int32) - accepted
    n_inserted = accepted.sum(dtype=torch.int32)
    survives = mask.bool() & (rank >= n_inserted - cap)
    # rows that are not written go to a spare row past the ring, dropped below
    slot = torch.where(survives, (bank.cursor + rank) % cap, cap).long()
    data = torch.cat([bank.data, bank.data.new_zeros((1, dim))])
    data.index_copy_(0, slot, embeddings.to(data.dtype))
    return MemoryBank(
        data=data[:cap],
        cursor=(bank.cursor + n_inserted) % cap,
        count=torch.clamp(bank.count + n_inserted, max=cap),
    )


def newest_first(bank: MemoryBank) -> torch.Tensor:
    """Valid rows ordered newest → oldest."""
    cap, cursor = bank.capacity, int(bank.cursor)
    order = [(cursor - 1 - i) % cap for i in range(int(bank.count))]
    return bank.data[torch.tensor(order, dtype=torch.long, device=bank.data.device)]
