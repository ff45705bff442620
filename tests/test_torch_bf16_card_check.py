"""The machinery of the bf16 card-vs-CPU check (chip_smoke.py phase 6,
tests/test_torch_train_cuda.py), run CPU against CPU: a bf16 fine-tune
step at 64², batch 8 on ``_torch_step_parity.disc_data``, recorded
(``reference_record``: every ReLU input and convolution output, and the
cotangent at each ReLU output) and run again with each layer given the
recorded input and cotangent (``pinned_record``).  The same device must
read every bf16 activation equal and stay inside ``BF16_CARD_LIMITS``;
the planted ``f32_residual_add`` must break them."""

import _torch_pinning as pn
import _torch_step_parity as sp
import torch

torch.set_num_threads(1)
SIZE, BATCH = 64, 8


def _readings(plant=None):
    data, cfg = sp.disc_data(SIZE), sp.step_config((SIZE, SIZE), BATCH, "bfloat16")
    host, decisions = sp.reference_record(cfg, data)
    assert len(decisions.relus) == 20 and len(decisions.convs) == 20
    assert len(decisions.cotangents) == 40  # at every ReLU and convolution output
    rec, layers = sp.pinned_record(cfg, data, "cpu", decisions, plant=plant)
    return {**sp.step_deltas(rec, host), **pn.layer_deltas(layers)}


def test_the_cpu_port_pinned_to_itself_reads_within_the_card_limits():
    reading = _readings()
    assert reading["layer_off"] == 0.0 and reading["head_off"] == 0.0, reading
    assert not sp.beyond(reading, sp.BF16_CARD_LIMITS), reading


def test_a_planted_f32_residual_add_breaks_the_card_limits():
    reading = _readings(pn.f32_residual_add)
    assert "layer_off" in sp.beyond(reading, sp.BF16_CARD_LIMITS), reading
