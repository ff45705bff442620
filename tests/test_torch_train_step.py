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

Limits (tests/_torch_step_parity.py ``CPU_LIMITS``), with the
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

Decisions pinned.  The train-mode step is piecewise smooth: a ReLU input
within rounding of zero, or a max-pool window with a near tie, takes the
other side when the summation order changes, and that moves whole terms of
the gradient.  XLA's and oneDNN's CPU convolutions pick their order by ISA
and thread count, so unpinned, the same commit passed on one machine
(gradients 9.5e-5 of scale) and failed on another (1.8e-3 on
``conv1.weight``, 6.8e-3 on ``layer1.1.conv2.weight``: one layer-1 sum
input of 6.6e-7 flipped).  So each step is compared under the JAX
forward's decisions (``_torch_train.Pinned``): the JAX train forward's
pre-activations on the same parameters and batch are captured
(``capture_intermediates``: every BatchNorm output, the residual sums
recomputed from their addends, the stem max-pool's input); the port's
forward then passes exactly the units the JAX forward passes and takes the
JAX argmax of each pooling window, and its backward follows.  Held on top
of the limits: at most ``MAX_FLIPS`` = 4 units on which the two forwards
disagree, each within ``BAND_FACTOR`` = 2 times its layer's own spread of
the boundary.  A layer's spread is the largest |port − JAX| over its
units that agree (at most 735–1,220 f32 ulps of the layer's scale: the
train-mode BatchNorm at batch 8 amplifies rounding), so the band follows
the data instead of a fixed count of ulps; a pooling window's two
candidates must lie within the factor times the largest |port − JAX| of
the pool input.

Measured under pinning, in five summation settings: as tier-1 runs them;
with ``XLA_FLAGS=--xla_cpu_multi_thread_eigen=false``; with the port on 8
threads; under ``taskset -c 0``; and with ``ONEDNN_MAX_CPU_ISA=AVX2``.
The first three leave both forwards' pre-activations bit-identical
(digests equal); ``taskset -c 0`` changes the JAX side's and
``ONEDNN_MAX_CPU_ISA=AVX2`` both sides', so those two run in another
summation order.  Over all five: gradients up to 1.07e-4 of scale, 0–2
flips, the farthest 0.30 of its layer's spread from the boundary (first
step 0.20, or no flip under AVX2; second step 0.17, 0.13 and 0.30 in the
default, taskset and AVX2 settings).  In the default setting: loss
2.4e-5, logits 1.4e-4, parameters and statistics 4.6e-6, bank 3.2e-5.
A planted fault, every conv input rounded to 10 mantissa bits (TF32's
rounding), breaks the loss, the logits, the gradients (2.9e-2 of scale),
the parameters, the bank and the flips (367–380).  Its flips stay within
the band (0.81–1.05 of a spread it inflates 280–360-fold), so the band
alone does not catch it
(``test_a_planted_rounding_fault_breaks_the_pinned_check``).
"""

import pytest
import torch
import _torch_train as T


@pytest.fixture(scope="module")
def jax_side():
    return T.make_jax_side()


def pinned_step(side, stage, batch, plant=False, **model):
    """The JAX step and the port's step under the JAX decisions on
    ``batch`` from ``side``'s init → (port trainer, metrics, state, the
    JAX results, pin)."""
    j = side.step(stage, side.init_state(stage), batch)
    pin = T.Pinned(side.decisions(side.params, side.stats, batch), round_conv_inputs=plant)
    tr, metrics, state = T.port_step(stage, side.params, side.stats, batch, pin=pin, **model)
    return tr, metrics, state, j, pin


@pytest.mark.parametrize("stage", ["projection", "fine_tune"])
def test_one_step_matches_jax(jax_side, stage):
    batch = T.seeded_batch(1)
    tr, metrics, state, j, pin = pinned_step(jax_side, stage, batch)
    margins = T.check_step(tr, metrics, state, *j, stage, pin)
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
    tr, metrics, state, j, pin = pinned_step(side, "fine_tune", batch, bank_fill_rows=rows)
    T.check_step(tr, metrics, state, *j, "fine_tune", pin)
    accepted = (batch[1] == 0) & (metrics["logits"].argmax(-1).numpy() == 0)
    # the full fill would take more rows than the first ``rows`` offer
    assert int(state.bank.count) == int(accepted[:rows].sum()) < int(accepted.sum())


def test_a_planted_rounding_fault_breaks_the_pinned_check(jax_side):
    """Every conv input rounded to 10 mantissa bits in the port's step
    (the CPU analogue of TF32): the pinned comparison must refuse it, on the
    gradients themselves and on the decisions."""
    tr, metrics, state, j, pin = pinned_step(jax_side, "fine_tune", T.seeded_batch(1),
                                             plant=True)
    margins = T.step_margins(tr, metrics, state, *j, "fine_tune", pin)
    assert {"grad_rel", "flips"} <= set(T.beyond(margins)), margins
