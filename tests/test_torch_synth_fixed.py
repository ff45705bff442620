"""Whole-engine parity of the port's synthesizer with the JAX package's:
the fixed-pose object regime (bottle, image level): the random affine (bf16 tent zoom + 3-shear rotation) on the canvas, the subject's own image as the cut source, one packed mask shared by the batch.

The JAX engine's keys are read into the port's draws (tests/_torch_synth.py);
both engines get the same seeded numpy inputs (64² images, batch 24).
Tolerance: labels equal; per sample, ≥ 99.8 % of the denormalised pixel
values within 2⁻⁷ (bf16 roundings XLA fuses away, .5 ties of shear shifts,
walk ranks truncated next to an integer); the largest |Δ| is printed.
"""

import dataclasses

import numpy as np
import torch
from _torch_synth import IMSIZE, PATCH, PIXEL_SHARE, compare_engines

from ssad_tpu_torch.data.synthetic import SynthSpec

torch.set_num_threads(1)
SPEC = SynthSpec(subject="bottle", imsize=(IMSIZE, IMSIZE), patch_localization=False,
                 patch_size=PATCH)


def test_fixed_regime_matches_jax():
    y, ref_y, share, largest = compare_engines(SPEC)
    print(f"fixed: largest |d| {largest:.6f}, worst sample share {share.min():.5f}")
    np.testing.assert_array_equal(y, ref_y)
    assert set(ref_y.tolist()) == {0, 1, 2, 3}
    assert share.min() >= PIXEL_SHARE, (share.min(), largest)


def test_a_missing_scar_copy_fails_the_limit():
    """Planted fault: one scar copy fewer in the port's draws must take
    every scar sample below the limit, and no other sample."""
    y, _, share, _ = compare_engines(
        SPEC, fault=lambda d: dataclasses.replace(d, scar_copies=d.scar_copies - 1))
    scar = y == 2
    print(f"fixed, one scar copy fewer: scar samples' shares {np.round(share[scar], 5)}")
    assert scar.any() and (share[scar] < PIXEL_SHARE).all(), share[scar]
    assert (share[~scar] >= PIXEL_SHARE).all()
