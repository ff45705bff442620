"""One train step of a bottleneck PeraNet in the port against the JAX
package's: tests/test_torch_train_step.py's comparison for the backbones
of ResNet-50 and Wide-ResNet-50-2.

The shallow bottleneck models of tests/test_torch_backbones.py
(``_models``: each package's ``make_backbone`` swapped for the JAX
``ResNet`` class at ``stage_sizes=(1, 1, 1, 1)``, so the PeraNets around
them, with the 3,584 → 512 head, are the real ones) at widths 1 and 2;
f32, 64², batch 8, the fine-tune stage with the bank fill.  Width 1 with
seeded statistics runs here, width 2 with the Flax-fresh ones in
tests/test_torch_train_step_bottleneck_wide.py (each file compiles one
JAX step, ~30 s on one core with a cold compilation cache).  Both steps run on the
same seeded batch from the same weights, the port's under the JAX
forward's ReLU and max-pool decisions (``_torch_train.Pinned``, its
bottleneck blocks' bn1, bn2 and bn3 + shortcut read from a capture
inside a jitted JAX program: an eager capture differs from the jitted
step in 3–11 units of a bottleneck model).  Held: loss, logits, every
trained parameter's gradient relative to its scale, the new parameters
and statistics, the bank, the disagreeing units and their band.

Limits (``LIMITS`` below; ResNet-18's ``CPU_LIMITS`` stay as they are),
each about twice the largest reading over widths 1 and 2, three seeds,
seeded and fresh statistics, in three summation settings (default,
``taskset -c 0``, ``ONEDNN_MAX_CPU_ISA=AVX2``; 36 steps): loss 1.5e-4
(5.27e-5), logits 6e-4 (2.67e-4), gradients 8e-4 of scale (2.65e-4;
3.53e-4 in an earlier reading of other batches), parameters and
statistics 3e-5 (1.5e-5), bank 1e-4 (1.96e-5), at most 30 disagreeing
units (10; 14 earlier), each within 2 of its layer's spread (0.47).
Spreads reach 3,038 ulps of scale against ResNet-18's 735–1,220: a
bottleneck block has three train-mode BatchNorms where a basic block has
two, and width 2 doubles its sums.

Planted fault (``test_a_planted_rounding_fault_breaks_the_bottleneck_check``):
every conv input rounded to 10 mantissa bits (TF32's rounding) gives
gradients 1.9e-2–4.5e-2 of scale and 782–1,163 flips over the same 12
cases (``taskset -c 0``), far past both limits.
"""

import types

import _torch_train as T
from test_torch_backbones import _models

#: the bottleneck step's limits (module docstring)
LIMITS = {"loss": 1.5e-4, "logits": 6e-4, "grad_rel": 8e-4, "params": 3e-5, "bank": 1e-4,
          "flips": 30, "band": T.BAND_FACTOR}
#: (width factor, Flax-fresh statistics) of this file's case
CASE = (1, False)
_sides = {}


def jax_side(monkeypatch, width, fresh):
    """The JAX side of a case's model (compiled once per case), with both
    packages' ``make_backbone`` swapped while the test runs."""
    _, params, stats, _ = _models(monkeypatch, "bottleneck", width, "float32", fresh=fresh)
    if (width, fresh) not in _sides:
        _sides[(width, fresh)] = T.make_jax_side(
            init=types.SimpleNamespace(params=params, stats=stats))
    return _sides[(width, fresh)]


def pinned_fine_tune_step(side, plant=False):
    batch = T.seeded_batch(1)
    j = side.step("fine_tune", side.init_state("fine_tune"), batch)
    pin = T.Pinned(side.decisions(side.params, side.stats, batch), round_conv_inputs=plant)
    tr, metrics, state = T.port_step("fine_tune", side.params, side.stats, batch, pin=pin)
    return T.step_margins(tr, metrics, state, *j, "fine_tune", pin), j


def check_bottleneck_step(monkeypatch, width, fresh):
    margins, j = pinned_fine_tune_step(jax_side(monkeypatch, width, fresh))
    assert not T.beyond(margins, LIMITS), margins
    assert int(j[0].bank.count) > 0
    assert margins["grad_worst"] is not None and margins["spread_ulps"] > 0
    print(margins)


def test_bottleneck_fine_tune_step_matches_jax(monkeypatch):
    check_bottleneck_step(monkeypatch, *CASE)


def test_a_planted_rounding_fault_breaks_the_bottleneck_check(monkeypatch):
    margins, _ = pinned_fine_tune_step(jax_side(monkeypatch, *CASE), plant=True)
    assert {"grad_rel", "flips"} <= set(T.beyond(margins, LIMITS)), margins
