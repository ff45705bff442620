"""One train step of the width-2 bottleneck PeraNet (Wide-ResNet-50-2's
blocks at depth 1, Flax-fresh statistics) in the port against the JAX
package's, at the limits of tests/test_torch_train_step_bottleneck.py,
whose docstring gives them, their measured margins and the planted fault
that breaks them.  A file of its own: each compiles one JAX step (~30 s
on one core with a cold compilation cache)."""

from test_torch_train_step_bottleneck import check_bottleneck_step


def test_wide_bottleneck_fine_tune_step_matches_jax(monkeypatch):
    check_bottleneck_step(monkeypatch, 2, True)
