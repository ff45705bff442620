"""Whole-engine parity of the port's synthesizer with the JAX package's:
patch mode with the screw pre-crop and per-image masks with 1-row placeholder coordinates (as prepare_pretext_data leaves them in patch mode).

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
SPEC = SynthSpec(subject="screw", imsize=(IMSIZE, IMSIZE), patch_localization=True,
                 patch_size=PATCH)


def test_precrop_regime_matches_jax():
    y, ref_y, share, largest = compare_engines(SPEC)
    print(f"precrop: largest |d| {largest:.6f}, worst sample share {share.min():.5f}")
    np.testing.assert_array_equal(y, ref_y)
    assert set(ref_y.tolist()) == {0, 1, 2, 3}
    assert share.min() >= PIXEL_SHARE, (share.min(), largest)
