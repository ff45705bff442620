"""One bf16 fine-tune step of the port against the JAX package's, pinned
layer by layer: PeraNet/ResNet-18 at 64², batch 8, ``compute_dtype``
bfloat16 (tests/_torch_train.py's configuration otherwise), the fill on,
the same seeded batch and the JAX init carried across.  The JAX step is
compiled with XLA's excess precision off (``DECLARED_PRECISION``: every
value its source declares bf16 is rounded, as op-by-op JAX does).  The
port's step runs under the JAX train forward's ReLU and max-pool
decisions, with every ReLU and convolution output taken from the JAX
forward (``_torch_pinning.Pinned`` with ``teacher``): each layer starts from
JAX's bf16 input, the backward runs the port's own ops.  Held: loss,
logits, every trained parameter's gradient (relative to its largest |g|,
at least 1e-3), the new parameters and BatchNorm statistics, the filled
bank (an unpinned eval forward), the decisions the port's own forward
would take (flips, band), and per layer the port's own ReLU input against
JAX's (``layer_off``: the share of elements not equal, ``layer_steps``:
the largest gap in bf16 steps; ``conv_*``: each convolution's output;
``head_steps``: the f32 head's, in f32 steps; ``_torch_pinning.layer_deltas``).

Limits (``LIMITS``): about twice the largest reading over seeds 1–3 in
three CPU settings (as tier-1 runs, ``ONEDNN_MAX_CPU_ISA=AVX2``,
``taskset -c 0``), from ``python tests/_torch_bf16.py step``: loss
4.8e-7, logits 1.2e-6, gradients 3.3e-2 of scale (the stem's and layer
1's BatchNorm biases; 2.2e-2 as tier-1 runs), parameters and statistics
3.2e-4, bank 1.8e-2, no flip, ReLU inputs 4.7e-4 off by ≤ 8 steps,
convolution outputs 3.7e-4 off by ≤ 1 step, head 7,196 f32 steps.  The
gradients' reading is the bf16 backward's own rounding over 20 layers
(the cotangents are not pinned: the JAX program's are not captured); in
f32 the same step holds 3e-4 (tests/test_torch_train_step.py).

Unpinned, the same step's train-mode logits over seeds 1–12 (``python
tests/_torch_bf16.py spread``; logits up to 3.02), max |Δlogit| median
(min–max): port bf16 vs JAX bf16 0.201 (0.155–0.276); JAX bf16 vs JAX
f32 0.323 (0.279–0.420); port bf16 vs port f32 0.322 (0.246–0.540); port
f32 vs JAX f32 1.0e-4 (6.9e-5–1.4e-4).  So the bf16 model is as far from
the f32 one in the port as in JAX, and the two bf16 models are nearer
each other than either is to f32: pinned, every bf16 layer reads ≤
4.7e-4 of its elements one step or a few apart, and the unpinned gap is
those flips carried through 20 layers.  With the bf16 JAX step at XLA's
default precision (``spread default``), which keeps each convolution's
f32 accumulation into its BatchNorm on the CPU: port bf16 vs JAX bf16
0.341 (0.236–0.587), JAX bf16 vs JAX f32 0.228 (0.151–0.341).  The JAX
bf16 model is nearer f32 there because it keeps those sums in f32; that
was ROADMAP's unexplained "0.317 against 0.245".

The planted fault (``_torch_pinning.f32_residual_add``) reads 0.290 of a block
sum's elements off by up to 61 steps (290× the limit).
"""

import _torch_pinning as pn
import pytest
from _torch_bf16 import pinned_step
from _torch_train import beyond, make_jax_side, seeded_batch


LIMITS = {"loss": 1e-6, "logits": 3e-6, "grad_rel": 7e-2, "params": 7e-4, "bank": 4e-2,
          "flips": 4, "band": 2.0, "layer_off": 1e-3, "layer_steps": 16.0,
          "conv_off": 1e-3, "conv_steps": 4.0, "head_steps": 15000.0}


@pytest.fixture(scope="module")
def jax_side():
    return make_jax_side(compute_dtype="bfloat16")


def test_pinned_bf16_step_matches_jax(jax_side):
    margins, layers = pinned_step(jax_side, seeded_batch(1))
    reading = {**margins, **pn.layer_deltas(layers)}
    assert not beyond(reading, LIMITS), reading


def test_a_planted_f32_residual_add_breaks_the_pinned_step(jax_side):
    _, layers = pinned_step(jax_side, seeded_batch(1), plant=pn.f32_residual_add)
    reading = pn.layer_deltas(layers)
    assert reading["layer_off"] > 10 * LIMITS["layer_off"], reading
