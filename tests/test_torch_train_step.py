"""One train step of the port against the JAX package's, the heart of the
training slice.

PeraNet/ResNet-18 at 64², batch 8, f32 compute.  The parameters come from
the JAX ``init_model`` through ``utils/jax_bridge``; the batch (x, y and
the clean originals) is given, seeded numpy, to both steps: the JAX
``Trainer``'s jitted ``train_step`` (its batch maker replaced by the given
batch) and the port's ``Trainer.train_step`` (likewise), both stages,
with the bank fill on.  Held: the loss and logits; the gradient of every
trained parameter, by mapped name (a jitted ``value_and_grad`` of the JAX
step's loss); the new parameters, BatchNorm statistics and bank.  Then a
second fine-tune step from the JAX optimizer state carried across
(momentum and the schedule's count, ``load_optax_momentum``), where the
lr has moved to the next epoch's (steps_per_epoch is 1): its loss, logits,
layer 4's and the head's gradients, statistics, bank and the update (its
own docstring).  A fill step with ``bank_fill_rows`` set is held too.

Limits (ssad_tpu_torch/train/step_parity.py ``CPU_LIMITS``), with the
largest |Δ| measured on the CPU over both stages and the second step in
brackets: loss 5e-5 (2.2e-5); logits 3e-4 absolute on logits up to 2.2
(1.2e-4); parameters and BatchNorm statistics 1e-5 absolute (5.3e-6);
gradients 3e-4 of each tensor's largest |g| (9.5e-5), with that largest
taken as at least 1e-3, because two biases followed by a train-mode
BatchNorm have an exactly zero gradient whose rounding noise (|g| ≤ 4e-8)
has no scale of its own (every other tensor's is ≥ 0.041); the bank's
rows 1e-4 (3.2e-5), its cursor and count equal.  The starting limits were
1e-5 on the loss and the logits and 1e-4 on the gradients; they were
raised because the train-mode forward at batch 8 amplifies f32 rounding:
one ulp of noise on the input alone moves these logits by 4.0–5.2e-5, and
the two packages sum their convolutions in different orders.
"""

import pytest
import torch
import _torch_train as T


@pytest.fixture(scope="module")
def jax_side():
    return T.make_jax_side()


@pytest.mark.parametrize("stage", ["projection", "fine_tune"])
def test_one_step_matches_jax(jax_side, stage):
    batch = T.seeded_batch(1)
    j_new, j_loss, j_logits, j_grads = jax_side.step(stage, jax_side.init_state(stage), batch)
    tr, metrics, state = T.port_step(stage, jax_side.params, jax_side.stats, batch)
    margins = T.check_step(tr, metrics, state, j_new, j_loss, j_logits, j_grads, stage)
    if stage == "projection":  # the frozen backbone did not move
        sd0 = T.state_dict_from_jax(jax_side.params, jax_side.stats)
        for name, p in tr.model.named_parameters():
            if name.startswith("feature_extractor."):
                assert torch.equal(p.detach(), sd0[name]), name
    print(stage, margins)


def test_a_fill_step_with_bank_fill_rows_matches_jax(jax_side):
    """ModelConfig.bank_fill_rows: only the batch's first rows are
    considered for the fill, in both packages (fine-tune, the same limits)."""
    rows = 3
    side = T.make_jax_side(init=jax_side, bank_fill_rows=rows)
    batch = T.seeded_batch(1)
    j_new, j_loss, j_logits, j_grads = side.step("fine_tune", side.init_state("fine_tune"), batch)
    tr, metrics, state = T.port_step("fine_tune", jax_side.params, jax_side.stats, batch,
                                     bank_fill_rows=rows)
    T.check_step(tr, metrics, state, j_new, j_loss, j_logits, j_grads, "fine_tune")
    accepted = (batch[1] == 0) & (metrics["logits"].argmax(-1).numpy() == 0)
    # the full fill would take more rows than the first ``rows`` offer
    assert int(state.bank.count) == int(accepted[:rows].sum()) < int(accepted.sum())
