"""The optimiser of each training stage: torch-semantics SGD, the per-step
cosine schedule, and the frozen backbone of the projection stage.

Counterpart of ssad_tpu/train/optim.py:23-75 (reference models.py:336-341,
tools.py:252-306):

* SGD(lr, momentum 0.9, weight decay 5e-4) with torch's semantics, which
  are the JAX package's optax chain (add_decayed_weights → trace →
  scale_by_learning_rate): g ← g + wd·p, buf ← μ·buf + g (the first step's
  buf is g), p ← p − lr·buf.  Weight decay reaches every trained
  parameter, BatchNorm scale/bias and biases included.
  ``torch.optim.SGD(momentum=μ, dampening=0, nesterov=False,
  weight_decay=wd)`` computes exactly this (tests/test_torch_optim.py
  holds it against optax).
* fine-tune: lr = base·½(1 + cos(π·((step // steps_per_epoch) mod T0)/T0)),
  torch's CosineAnnealingWarmRestarts stepped once per epoch with
  T0 = the stage's epochs, evaluated per step from the optimiser's own
  step count (saved with its state).
* projection: constant lr, and the backbone frozen — its parameters get
  no gradient, no update and no decay, so they stay bit-identical.  Its
  BatchNorms still run in training mode and update their running
  statistics, as under Flax's ``train=True`` with ``set_to_zero``
  updates; calling ``.eval()`` on the frozen backbone would change that.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
from torch import nn

from ssad_tpu_torch.config import OptimConfig

BACKBONE_PREFIX = "feature_extractor."


def cosine_warm_restarts(base_lr: float, t0_epochs: int,
                         steps_per_epoch: int) -> Callable[[int], float]:
    """Per-step schedule equal to CosineAnnealingWarmRestarts(T_0=t0_epochs,
    eta_min=0) stepped once per epoch."""

    def schedule(step: int) -> float:
        t_cur = (step // max(steps_per_epoch, 1)) % t0_epochs
        return base_lr * 0.5 * (1.0 + math.cos(math.pi * t_cur / t0_epochs))

    return schedule


def is_backbone_param(name: str) -> bool:
    """The reference's freeze_net(['backbone']) set (models.py:185-189)."""
    return name.startswith(BACKBONE_PREFIX)


class StageOptimizer:
    """torch.optim.SGD over the stage's trained parameters, its lr set from
    the schedule before every step.  Building one sets ``requires_grad`` of
    the model's parameters for the stage (the backbone's off in projection,
    every one on in fine-tune)."""

    def __init__(self, model: nn.Module, cfg: OptimConfig, stage: str, steps_per_epoch: int):
        if stage == "projection":
            self.schedule = lambda step: cfg.projection_lr
        elif stage == "fine_tune":
            self.schedule = cosine_warm_restarts(cfg.fine_tune_lr, cfg.fine_tune_epochs,
                                                 steps_per_epoch)
        else:
            raise ValueError(f"unknown stage {stage!r}")
        self.stage = stage
        trained = []
        for name, p in model.named_parameters():
            p.requires_grad_(stage == "fine_tune" or not is_backbone_param(name))
            if p.requires_grad:
                trained.append(p)
        self.sgd = torch.optim.SGD(trained, lr=self.schedule(0), momentum=cfg.momentum,
                                   dampening=0.0, nesterov=False,
                                   weight_decay=cfg.weight_decay)
        self.count = 0  # steps taken: the schedule's clock

    @property
    def params(self):
        return self.sgd.param_groups[0]["params"]

    def zero_grad(self) -> None:
        self.sgd.zero_grad(set_to_none=True)

    def step(self) -> None:
        self.sgd.param_groups[0]["lr"] = self.schedule(self.count)
        self.sgd.step()
        self.count += 1

    def state_dict(self) -> dict:
        return {"stage": self.stage, "count": self.count, "sgd": self.sgd.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        if state["stage"] != self.stage:
            raise ValueError(f"optimizer state of stage {state['stage']!r}, not {self.stage!r}")
        self.sgd.load_state_dict(state["sgd"])
        self.count = int(state["count"])
