"""Whole-engine parity of the port's synthesizer with the JAX package's:
the non-fixed object regime (hazelnut, image level): no affine, one mask and packed coordinate list per image.

The JAX engine's keys are read into the port's draws (tests/_torch_synth.py);
both engines get the same seeded numpy inputs (64² images, batch 24).
Tolerance: labels equal; per sample, ≥ 99.8 % of the denormalised pixel
values within 2⁻⁷ (bf16 roundings XLA fuses away, .5 ties of shear shifts,
walk ranks truncated next to an integer); the largest |Δ| is printed.
"""

import numpy as np
import torch
from _torch_synth import IMSIZE, PATCH, PIXEL_SHARE, compare_engines

from ssad_tpu_torch.data.synthetic import SynthSpec

torch.set_num_threads(1)
SPEC = SynthSpec(subject="hazelnut", imsize=(IMSIZE, IMSIZE), patch_localization=False,
                 patch_size=PATCH)


def test_nonfixed_regime_matches_jax():
    y, ref_y, share, largest = compare_engines(SPEC)
    print(f"nonfixed: largest |d| {largest:.6f}, worst sample share {share.min():.5f}")
    np.testing.assert_array_equal(y, ref_y)
    assert set(ref_y.tolist()) == {0, 1, 2, 3}
    assert share.min() >= PIXEL_SHARE, (share.min(), largest)
