"""One train step on the card against the same step in the CPU port, and one
step with no host sync.  Every test takes the ``cuda_device`` fixture and
skips where there is no card.

This file imports neither JAX nor the JAX package, so it runs on a
machine without them:
    python -m pytest --noconftest tests/test_torch_train_cuda.py
The step (tests/_torch_step_parity.py): PeraNet/ResNet-18 at 64²,
batch 8, f32 with TF32 off, on the seeded disc images, from the same
initial weights and the same draws (synthesis is bit-identical on both
devices), fine-tune with the bank fill on; then an insert of the batch's
eval embeddings under a given mask.  Limits: ``CPU_LIMITS``, those of the
CPU parity tests against JAX: loss 5e-5, logits 3e-4, parameters and
statistics 1e-5, bank rows 1e-4, the gradients 3e-4 of each tensor's
largest |g| (at least 1e-3).

The bf16 step, layer by layer (``test_card_bf16_step_matches_the_cpu_step_
layer_by_layer``): the CPU step records every ReLU input and convolution
output and the cotangent at each
(``_torch_step_parity.reference_record``); the card step runs with each layer
given the CPU's input and cotangent (``pinned_record``), so each layer's
own rounding is read, under ``BF16_CARD_LIMITS`` (measured on the card,
_torch_step_parity.py), with cuDNN's TF32 on (PyTorch's default) and off, which
no bf16 convolution reads; the planted f32 residual add must break them.
"""

import dataclasses

import _torch_pinning as pn
import _torch_step_parity as sp
import pytest
import torch
from _torch_port import cuda_device  # noqa: F401  (fixture)

from ssad_tpu_torch.train.trainer import Trainer, stage_generator

SIZE, BATCH = 64, 8


def test_card_step_matches_the_cpu_step(cuda_device):
    data, cfg = sp.disc_data(SIZE), sp.step_config((SIZE, SIZE), BATCH)
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        card = sp.step_record(cfg, data, cuda_device)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    host = sp.step_record(cfg, data, "cpu")
    deltas = sp.step_deltas(card, host)
    assert not sp.beyond(deltas), deltas
    assert int(host["given"][2]) == sum(i % 3 != 1 for i in range(BATCH))


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
def test_a_fill_step_runs_without_host_sync(cuda_device, compute_dtype):
    cfg = sp.step_config((SIZE, SIZE), BATCH)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, compute_dtype=compute_dtype))
    tr = Trainer(cfg, sp.disc_data(SIZE), cuda_device)
    state = tr.init_state("fine_tune", seed=0)
    dd = tr.device_data("train")
    gen = stage_generator(0, 2)
    state, _ = tr.train_step(state, tr.upload_draws(gen, dd), dd, fill=True)  # warm-up
    uploaded = tr.upload_draws(gen, dd)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, m = tr.train_step(state, uploaded, dd, fill=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert bool(torch.isfinite(m["loss"])) and state.optimizer.count == 2


@pytest.mark.parametrize("cudnn_tf32", [True, False])
def test_card_bf16_step_matches_the_cpu_step_layer_by_layer(cuda_device, cudnn_tf32):
    data, cfg = sp.disc_data(SIZE), sp.step_config((SIZE, SIZE), BATCH, "bfloat16")
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, cudnn_tf32
    try:
        host, decisions = sp.reference_record(cfg, data)
        card, layers = sp.pinned_record(cfg, data, cuda_device, decisions)
        bad, bad_layers = sp.pinned_record(cfg, data, cuda_device, decisions,
                                           plant=pn.f32_residual_add)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    reading = {**sp.step_deltas(card, host), **pn.layer_deltas(layers)}
    assert not sp.beyond(reading, sp.BF16_CARD_LIMITS), reading
    planted = {**sp.step_deltas(bad, host), **pn.layer_deltas(bad_layers)}
    assert "layer_off" in sp.beyond(planted, sp.BF16_CARD_LIMITS), planted
