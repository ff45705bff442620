"""One train step held against another: its record, the largest
differences between two records, and the limits they are held to.

The CPU parity tests against the JAX package (tests/_torch_train.py), the
card-vs-CPU test (tests/test_torch_train_cuda.py) and chip_smoke.py's
phase 6 read their limits here.

``CPU_LIMITS``: f32 at 64², batch 8.  The train-mode step is piecewise
smooth: a ReLU whose input lies within rounding of zero, or a max-pool
window with a near tie, takes the other side under one ulp of input
noise, and that moves whole terms of the gradient.  The port matches the
JAX step on the CPU parity tests' seeded batches, and the card matches the
CPU on the disc images of ``disc_data``, within these limits.

``TREE_256_LIMITS``: the card against the CPU at 256², batch 16, on the
seeded bottle tree (``_torch_card_fixtures.write_synth_tree``).  There
one layer-3 ReLU input sits within 2e-6 of zero (64² shows the same: one
flip moves ``layer3.1.conv2.weight``'s gradient 5.7 % of its scale), so
the two devices differ by more than the CPU limits allow.  The limits are
fixed constants, about twice the card's readings (NVIDIA H100 80GB HBM3,
700 W, the same in three runs: loss 2.4e-6, logits 2.3e-5, parameters
and statistics 5.3e-5, gradients 3.75e-2 of scale, filled bank 5.5e-4,
given-mask bank 5.7e-4); PERF.md §6 gives the runs and what a planted
fault (TF32 on) reads against them.

``BF16_CARD_LIMITS`` (64², batch 8), ``BF16_TREE_256_LIMITS`` (256²,
batch 16) and ``BF16_EVAL_LIMITS`` (the eval forward, image and patch
mode): the bf16 card step and forward against the CPU port's, each layer
given the CPU's input (every ReLU output and convolution output) and the
step's backward the CPU's cotangent at each of them
(``reference_record``, ``pinned_record``), read per layer
(``_torch_pinning.Pinned.layers``, grouped by ``_torch_pinning.layer_deltas``):
``layer_*`` the backbone's ReLU inputs, ``conv_*`` its convolutions'
outputs and ``cotangent_*`` its cotangents, in bf16 steps (share off,
largest gap); ``head_*`` the f32 head's, in f32 steps.  About twice the
card's readings (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py phase 6, or
``python3 chip_smoke.py --bf16``): 64² loss 0, logits 6.3e-7,
parameters and statistics 2.0e-5, gradients 3.2e-3 of scale (one bf16
step of a bf16 weight gradient), given-mask bank 4.2e-3, ReLU inputs
9.2e-5 off by ≤ 2 steps, convolutions 7.9e-4 off by ≤ 1 step, head 2,394
f32 steps, cotangents 2.6e-3 off by ≤ 32 steps (head 688); 256² loss 0,
logits 9.5e-7, parameters 3.9e-5, gradients 6.5e-3, given bank 1.8e-3,
ReLU inputs 1.7e-4 off by ≤ 16 steps, convolutions 1.4e-3 off by ≤ 1,
head 8,442, cotangents 3.2e-3 by ≤ 48 (head 832); the forward's ReLU
inputs 2.7e-5 / 2.9e-5 off by ≤ 8 (image) / 1 (patch) steps,
convolutions 1.4e-3 / 8.0e-4 off by ≤ 1, embeddings 3.6e-7 / 1.1e-6,
logits 1.5e-7 / 4.3e-7, head 388 / 2,444.  cuDNN's and oneDNN's bf16
convolutions sum in other orders, so about one output in a thousand
rounds to the neighbouring bf16 value.  The planted ``f32_residual_add``
reads 0.25–0.29 of ReLU inputs off by up to 63 steps.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ssad_tpu_torch.config import DataConfig, ModelConfig, TrainConfig
from ssad_tpu_torch.data import masks
from ssad_tpu_torch.data.mvtec import PretextData
from ssad_tpu_torch.train.memory_bank import init_bank, insert
from ssad_tpu_torch.train.trainer import Trainer, bank_fill_embeddings, stage_generator

from _torch_pinning import Decisions, Pinned, Recorder, conv_names, relu_names

#: gradients are held relative to each tensor's largest |g|, at least this
GRAD_FLOOR = 1e-3
CPU_LIMITS = {"loss": 5e-5, "logits": 3e-4, "state": 1e-5, "grad_rel": 3e-4,
              "bank": 1e-4, "given": 1e-4}
TREE_256_LIMITS = {"loss": 5e-5, "logits": 3e-4, "state": 1.2e-4, "grad_rel": 8e-2,
                   "bank": 1.2e-3, "given": 1.2e-3}
#: the bf16 step and forward on the card against the CPU port, each layer
#: given the CPU's input and cotangent (``pinned_record``; chip_smoke.py
#: phase 6), about twice the card's readings (module docstring)
BF16_CARD_LIMITS = {"loss": 5e-7, "logits": 2e-6, "state": 4e-5, "grad_rel": 8e-3,
                    "bank": 8e-3, "given": 8e-3, "layer_off": 2e-4, "layer_steps": 4.0,
                    "conv_off": 2e-3, "conv_steps": 4.0, "head_steps": 5000.0,
                    "cotangent_off": 6e-3, "cotangent_steps": 64.0,
                    "head_cotangent_steps": 1500.0}
BF16_TREE_256_LIMITS = {"loss": 5e-7, "logits": 2e-6, "state": 8e-5, "grad_rel": 1.3e-2,
                        "bank": 5e-3, "given": 4e-3, "layer_off": 4e-4, "layer_steps": 32.0,
                        "conv_off": 3e-3, "conv_steps": 4.0, "head_steps": 2e4,
                        "cotangent_off": 8e-3, "cotangent_steps": 96.0,
                        "head_cotangent_steps": 2000.0}
BF16_EVAL_LIMITS = {"latent_space": 3e-6, "classifier": 1e-6, "layer_off": 6e-5,
                    "layer_steps": 16.0, "conv_off": 3e-3, "conv_steps": 4.0, "head_steps": 5000.0}
#: capacity of the filled bank and of the one that takes the given-mask insert
BANK_ROWS = 16


def disc_data(size: int = 64, n: int = 6, seed: int = 0) -> PretextData:
    """Seeded ``size``² images with a bright disc, the disc as the fixed
    subject mask; ``n`` − 2 train and 2 val images."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    c = size // 2
    disc = (yy - c) ** 2 + (xx - c) ** 2 < (size * 11 // 32) ** 2
    imgs = np.clip(rng.uniform(0.3, 0.5, (n, size, size, 3)) + 0.3 * disc[None, :, :, None],
                   0, 1).astype(np.float32)
    coords, count = masks.pack_coords(disc.astype(np.uint8))
    return PretextData(subject="bottle", imsize=(size, size), train_images=imgs[:n - 2],
                       val_images=imgs[n - 2:], cut_pool=imgs[:1],
                       fixed_mask=disc.astype(np.float32), fixed_coords=coords,
                       fixed_count=count)


def step_config(imsize, batch: int, compute_dtype: str = "float32") -> TrainConfig:
    """The data's imsize, ``batch``; f32 unless ``compute_dtype`` says
    otherwise."""
    return TrainConfig(data=DataConfig(subject="bottle", imsize=tuple(imsize),
                                       batch_size=batch, min_dataset_length=batch),
                       model=ModelConfig(compute_dtype=compute_dtype, memory_bank_size=BANK_ROWS))


def step_record(cfg: TrainConfig, data: PretextData, device, mode=None, plant=None) -> Dict:
    """One fine-tune step (fill on) from the seed-0 init and the seed-0
    draws, then a given-mask insert of the batch's eval embeddings → host
    f64 copies of what is compared.  ``mode``: a ``Recorder`` or
    ``Pinned`` the step runs under; ``plant``: a context made from the
    trainer's model (``_torch_pinning.f32_residual_add``) the step runs under."""
    trainer = Trainer(cfg, data, device)
    state = trainer.init_state("fine_tune", seed=0)
    dd = trainer.device_data("train")
    uploaded = trainer.upload_draws(stage_generator(0, 2), dd)
    with plant(trainer.model) if plant is not None else contextlib.nullcontext(), \
            mode if mode is not None else contextlib.nullcontext():
        state, m = trainer.train_step(state, uploaded, dd, fill=True)
    _, _, orig = trainer.make_batch(dd, *uploaded)
    mask = torch.arange(orig.shape[0], device=orig.device) % 3 != 1
    given = insert(init_bank(BANK_ROWS, 512, orig.device),
                   bank_fill_embeddings(trainer.model, orig), mask)

    def host(t):
        return t.detach().cpu().double()

    return {
        "loss": host(m["loss"]), "logits": host(m["logits"]),
        "state": {k: host(v) for k, v in trainer.model.state_dict().items()
                  if not k.endswith("num_batches_tracked")},
        "grads": {n: host(p.grad) for n, p in trainer.model.named_parameters()},
        "bank": [host(t) for t in state.bank], "given": [host(t) for t in given],
    }


def _max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max()) if a.numel() else 0.0


def step_deltas(a: Dict, b: Dict) -> Dict[str, float]:
    """Largest |a − b| of each compared quantity; gradients relative to
    each tensor's largest |g| in ``b`` (at least GRAD_FLOOR); a bank whose
    cursor or count differs reads inf."""
    out = {"loss": _max_abs(a["loss"], b["loss"]),
           "logits": _max_abs(a["logits"], b["logits"]),
           "state": max(_max_abs(a["state"][k], v) for k, v in b["state"].items()),
           "grad_rel": max(_max_abs(a["grads"][n], g) / max(float(g.abs().max()), GRAD_FLOOR)
                           for n, g in b["grads"].items())}
    for key in ("bank", "given"):
        (ad, ac, an), (bd, bc, bn) = a[key], b[key]
        same = int(ac) == int(bc) and int(an) == int(bn)
        out[key] = _max_abs(ad, bd) if same else float("inf")
    return out


def beyond(deltas: Dict[str, float], limits: Optional[Dict[str, float]] = None) -> List[str]:
    """The keys of ``deltas`` above their limit (CPU_LIMITS by default)."""
    limits = limits or CPU_LIMITS
    return [k for k, tol in limits.items() if not deltas[k] <= tol]


def pinned_record(cfg: TrainConfig, data: PretextData, device, decisions: Decisions,
                  plant=None) -> Tuple[Dict, Dict[str, Dict[str, float]]]:
    """``step_record`` on ``device`` with every layer given the reference
    run's input and cotangent (``Pinned`` with ``teacher`` and the
    decisions' cotangents) → (record, per-layer readings); ``plant``: as
    in ``step_record``."""
    pin = Pinned(decisions.to(device), teacher=True)
    rec = step_record(cfg, data, device, mode=pin, plant=plant)
    return rec, pin.layers()


def reference_record(cfg: TrainConfig, data: PretextData, device="cpu") -> Tuple[Dict, Decisions]:
    """``step_record`` on ``device`` (the CPU port by default) with its
    decisions recorded: every ReLU input and convolution output, and the
    cotangent at each of them."""
    model = Trainer(cfg, data, "cpu").model
    rec = Recorder(relu_names(model), conv_names(model), cotangents=True)
    return step_record(cfg, data, device, mode=rec), rec.decisions()
