"""Data-parallel training (``train --data-shards``): two gloo ranks against
one rank for one f32 fine-tune fill step of ResNet-18 at 64², batch 8.

JAX's sharded step is its single-device step (global-view code), so the
two ranks must reproduce the one-rank step: each keeps its 4 rows of the
batch, the BatchNorm statistics are the batch's (averaged over the ranks
by a differentiable all-reduce), the gradients are averaged, and the bank
fill sees the whole batch.  Held within _torch_step_parity.py's
``CPU_LIMITS`` (loss, logits, gradients relative to scale, parameters
and BatchNorm statistics, bank) under pinned decisions
(tests/_torch_parallel.py ``Pin``: rank r takes its rows of the one-rank
forward's ReLU and max-pool decisions).  Measured over seeds 0–2 on the
CPU (the largest of each): loss 4.9e-6 (limit 5e-5), logits 4.4e-5
(3e-4), parameters and statistics 2.1e-6 (1e-5), gradients 5.7e-5 of
scale (3e-4), bank 1.8e-5 (1e-4); the two ranks end bit-equal to each
other.  The planted fault, plain DDP (each rank's BatchNorm statistics
its own), must break the limits: it reads loss 0.28–0.46, logits
2.2–3.5, gradients 2.3–14.5 of scale.

In a world of one the distributed path is the plain trainer, bit for bit
(every all-reduce an identity)."""

import pytest
import torch
from _torch_parallel import decisions, deltas, dp_step, free_port, run_ranks, seeded_inputs
from _torch_step_parity import CPU_LIMITS

from ssad_tpu_torch.parallel import distributed as dist_mod
from ssad_tpu_torch.train.trainer import DataGroup

torch.set_num_threads(1)

LIMITS = {k: CPU_LIMITS[k] for k in ("loss", "logits", "state", "grad_rel", "bank")}


@pytest.fixture(scope="module")
def inputs():
    inp = seeded_inputs(0)
    inp["decisions"] = decisions(inp["state_dict"], inp["batch"][0])
    return inp


@pytest.fixture(scope="module")
def one_rank(inputs):
    return dp_step(inputs)


@pytest.fixture(scope="module")
def two_ranks(inputs, tmp_path_factory):
    d = tmp_path_factory.mktemp("dp")
    torch.save(inputs, d / "inputs.pt")
    return run_ranks("dp_step", 2, d / "inputs.pt", d)


def test_two_gloo_ranks_reproduce_the_one_rank_step(one_rank, two_ranks):
    got = deltas(two_ranks[0]["step"], one_rank)
    assert not [k for k, tol in LIMITS.items() if not got[k] <= tol], got
    assert int(one_rank["bank"][2]) > 0  # the fill took rows
    # every rank holds the same state and bank
    a, b = two_ranks[0]["step"], two_ranks[1]["step"]
    assert all(torch.equal(a["state"][k], b["state"][k]) for k in a["state"])
    assert all(torch.equal(u, v) for u, v in zip(a["bank"], b["bank"]))
    assert torch.equal(a["logits"], b["logits"]) and torch.equal(a["loss"], b["loss"])


def test_per_rank_batchnorm_breaks_the_limits(one_rank, two_ranks):
    """Plain DDP's BatchNorm (each rank's own statistics) is another
    function: the planted fault must fail the test above."""
    got = deltas(two_ranks[0]["per_rank_bn"], one_rank)
    assert [k for k, tol in LIMITS.items() if not got[k] <= tol], got


def test_world_of_one_is_the_plain_step_bit_for_bit(inputs, one_rank):
    with dist_mod.process_group(f"127.0.0.1:{free_port()}", 1, 0, "cpu", timeout_s=60):
        got = dp_step(inputs, DataGroup(None, 0, 1))
    assert deltas(got, one_rank) == {k: 0.0 for k in LIMITS}


def test_an_indivisible_batch_is_refused():
    from _torch_parallel import DATA, step_cfg

    from ssad_tpu_torch.train.trainer import Trainer

    with pytest.raises(ValueError, match="does not split over 3"):
        Trainer(step_cfg(), DATA, "cpu", DataGroup(None, 0, 3))
