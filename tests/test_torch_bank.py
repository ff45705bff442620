"""The port's memory-bank insert against ssad_tpu.train.memory_bank.insert on
the same seeded embeddings and masks: a partly filled ring that wraps, an
empty mask, and more accepted rows in one call than the capacity (the
newest win).  data, cursor and count must be equal: the same rows are
copied to the same slots, so bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssad_tpu.train import memory_bank as jbank
from ssad_tpu_torch.train import memory_bank as bank
from ssad_tpu_torch.utils.jax_bridge import bank_from_numpy

torch.set_num_threads(1)

CAP, DIM = 10, 6
CASES = {  # name: [(rows, accept probability)] inserted one after another
    "wraps": [(8, 0.7), (8, 0.7), (8, 0.7)],
    "empty_mask": [(5, 1.0), (7, 0.0)],
    "over_capacity": [(3, 1.0), (25, 0.9)],
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_insert_matches_jax(name):
    rng = np.random.default_rng(sorted(CASES).index(name))
    ours = bank.init_bank(CAP, DIM)
    theirs = jbank.init_bank(CAP, DIM)
    for rows, p in CASES[name]:
        emb = rng.normal(size=(rows, DIM)).astype(np.float32)
        mask = rng.uniform(size=rows) < p
        theirs = jbank.insert(theirs, jnp.asarray(emb), jnp.asarray(mask))
        ours = bank.insert(ours, torch.from_numpy(emb), torch.from_numpy(mask))
        np.testing.assert_array_equal(ours.data.numpy(), np.asarray(theirs.data))
        assert int(ours.cursor) == int(theirs.cursor)
        assert int(ours.count) == int(theirs.count)
        assert ours.cursor.dtype == ours.count.dtype == torch.int32
    assert ours.data.shape == (CAP, DIM)
    np.testing.assert_array_equal(bank.newest_first(ours).numpy(),
                                  np.asarray(jbank.newest_first(theirs)))


def test_insert_leaves_its_input_bank_unchanged():
    b0 = bank.init_bank(4, 3)
    b1 = bank.insert(b0, torch.ones(2, 3), torch.tensor([True, True]))
    assert not b0.data.any() and int(b0.cursor) == 0 and int(b1.count) == 2


def test_bank_from_numpy_reads_a_jax_bank():
    rng = np.random.default_rng(3)
    theirs = jbank.insert(jbank.init_bank(CAP, DIM),
                          jnp.asarray(rng.normal(size=(13, DIM)).astype(np.float32)),
                          jnp.asarray(rng.uniform(size=13) < 0.8))
    ours = bank_from_numpy(np.asarray(theirs.data), theirs.cursor, theirs.count)
    np.testing.assert_array_equal(bank.newest_first(ours).numpy(),
                                  np.asarray(jbank.newest_first(theirs)))
