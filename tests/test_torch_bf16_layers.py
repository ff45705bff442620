"""The bf16 model layer by layer against the JAX package's, on the CPU: each
module of the port against the JAX module on the same bf16 input (the
JAX predecessor's output), the same parameters (carried by the bridge's
layout) and the same seeded cotangent, the JAX module run jitted as the
package runs it.  The port's module runs under the JAX module's ReLU and
max-pool decisions with every ReLU output taken from the JAX run
(``_torch_pinning.Pinned(teacher=True)``, tests/_torch_bf16.py), so each
layer starts from JAX's input and what differs is its own rounding.

Modules (batch 8; tests/_torch_bf16.py ``all_readings``): the 7×7/s2 stem
conv with BN, ReLU and the max-pool on 32² images; the folded 4×4 stem
(eval); a basic block without and with a projection (64 → 64, 64 → 128
/s2, at 8²); bottleneck blocks with and without a projection at width
factors 1 and 2 (64 → 128 /s2, 128 → 128; filters 32); the head (tap
means of bf16 layer-2/3 maps, concat, Dense + BN, the latent MLP, the
classifier; f32 as in both packages); softmax cross-entropy on the bf16
model's logits.  Train mode here, eval mode in tests/test_torch_bf16_layers_eval.py.

Read per module: each ReLU input and convolution output against the JAX
module's captured one (``layer_off``: the share of elements not equal;
``layer_steps``: the largest gap in steps of the reference's dtype, each
element's step taken at max(|ref|, 2⁻⁸·max|ref|)); the input cotangents
(``cot_*``, the same units; the stem's image cotangent in bf16 steps); the
f32 parameter gradients relative to each tensor's largest |g| (at least
1e-3); in train mode the running statistics (absolute).

The JAX modules are compiled with XLA's excess precision off
(``_torch_train.DECLARED_PRECISION``), so they round every value their
source declares bf16, as op-by-op JAX does and the port does.  At XLA's
default the program compiled for the CPU keeps a bf16 convolution's f32
accumulation where the BatchNorm reads it (and f32 weight gradients);
held against that program, the port's BatchNorm outputs read 35–53 % of
elements off by up to 128 steps.  That is the CPU compiler's choice, not
the source's: a TPU program's is not known, and cuDNN's bf16 convolution
rounds as the source says.

Limits (``LIMITS``, ``HEAD_LIMITS``): about twice the largest reading over
seeds 0–2, as tier-1 runs and under ``taskset -c 0``, from ``python
tests/_torch_bf16.py layers``.  Readings, bf16 modules (stem, blocks):
ReLU inputs and convolution outputs 2.44e-4 of elements off, by ≤ 8
steps; input cotangents 4.09e-2 off, by ≤ 64 steps (at the 2⁻⁸·max
floor: ≤ a quarter step at the tensor's largest); gradients 4.03e-3 of
scale (one bf16 step of a bf16 weight gradient); statistics 1.19e-6.
Head (f32): the latent ReLU inputs 10,674 f32 steps, its input cotangents
12,454, gradients 1.39e-2 (the concat BatchNorm's bias: the f32
train-mode BatchNorm at batch 8 amplifies summation noise, the same with
an f32 model), statistics 7.2e-7; every element of its f32 tensors
differs, so only steps are held.  The cotangent shares come from
train-mode BatchNorm: a one-step difference of one element moves its
channel's mean terms and so its neighbours.  The limits hold a CPU with
native bf16 (AVX-512 BF16 / AMX, as tier-1 runs): with
``ONEDNN_MAX_CPU_ISA=AVX2`` oneDNN's bf16 convolution backward reads
0.68 of input cotangents off by up to 256 floor steps and gradients
1.32e-2 of scale, the forward as above.

Planted fault (``_torch_pinning.f32_residual_add``: a basic block's bn2
output left in f32, the residual add done in f32 and rounded once after
the ReLU): its sum reads 0.142 of elements off (seed 0, train; 285×)
against the limit 5e-4.
"""

import _torch_pinning as pn
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_bf16 import (BF, LIMITS, TRAIN_CASES, all_readings, compare,
                         module_readings_within_limits, summary)

from ssad_tpu.models import resnet as jr
from ssad_tpu_torch.models import resnet as pr


@pytest.fixture(scope="module")
def readings():
    return all_readings(0, True)


@pytest.mark.parametrize("mode, case", [("train", c) for c in TRAIN_CASES])
def test_module_matches_jax(readings, mode, case):
    ok, r = module_readings_within_limits(readings, case)
    assert ok, r


def test_a_planted_f32_residual_add_breaks_the_limits():
    """The basic block with bn2's output in f32 and the residual add in
    f32, rounded after the ReLU: its sum reads far beyond ``layer_off``."""
    x = jnp.asarray(np.maximum(np.random.default_rng(0).normal(0, 1, (8, 8, 8, 64)), 0), BF)
    r, _ = compare("block", jr.BasicBlock(64, 1, dtype=BF),
                   pr.BasicBlock(64, 64, 1, torch.bfloat16), (x,), True, 0,
                   plant=pn.f32_residual_add)
    s = summary(r)
    assert s["layer_off"] > 10 * LIMITS["layer_off"], s
