"""Whole-engine parity of the port's synthesizer with the JAX package's at
the parity run's 256², one case per regime: bottle (fixed pose: the
affine, one shared mask), hazelnut (non-fixed: one mask per image) and
carpet (texture: the cut pool), image level, batch 8.

The JAX engine's keys are read into the port's draws
(``_torch_jax_random.jax_draws_np``, held to the JAX key tree by
tests/test_torch_jax_random.py).  Against JAX's ``batched_synthesizer``
compiled at declared precision (``xla_allow_excess_precision=False``, as
tests/_torch_train.py's ``declared_jit``), where every bf16 intermediate
the source declares is rounded, the port's batch is equal bit for bit:
labels and every value.

At XLA's CPU default the JAX program keeps some of those intermediates in
f32 inside its fusions, so the 64² tests hold the port to ≥ 99.8 % of a
sample's values within 2⁻⁷ (tests/_torch_synth.py).  At 256², over seed
0's first 16 samples (``python tests/_torch_synth.py``), the worst share
is bottle 0.99947, carpet 0.99946 (sample 1 of each, a scar with jitter
order 5) and hazelnut 0.98393, below the 0.998 limit: sample 9, a good
sample whose colour jitter runs saturation, contrast, brightness (largest
|Δ| 0.0128).  The op where it parts is ``adjust_contrast``
(ssad_tpu/ops/image.py:136-140): run alone at XLA's default among
declared-precision ops it puts 1.47 % of that sample's values beyond 2⁻⁷
(largest 0.0105, mean −1.41e-3); saturation alone 0.023 %, brightness and
the normalisation none.  The port computes the declared function, so
nothing is repaired.

The one TPU-only rounding that scripts/tpu_precision_census.py finds in
the synthesizer is the line's Savitzky–Golay smoothing
(ssad_tpu/ops/rasterize.py:152: an f32 dot at DEFAULT precision, which a
TPU program runs as bf16 × bf16 → bf16; the segment pick at
ssad_tpu/data/synthetic.py:688 then reads bf16 points).  Emulated on the
CPU in a copy of the JAX function, it changes 3.3e-4 and 7.3e-4 of the
values of seed 0's two line samples at batch 8 (20 to 50 pixels of a 256²
image; 3.3e-4 to 7.3e-4 over the first 16) and no other sample.
"""

import _torch_jax_random as jr
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_synth import batch_inputs, jax_spec

from ssad_tpu.data import synthetic as js
from ssad_tpu_torch.data import synthetic as syn

torch.set_num_threads(1)
SIZE, BATCH, SEED = 256, 8, 0
#: the largest share of a line sample's values that the TPU's bf16 line
#: smoothing may change (measured on seed 0's first 16: 3.3e-4 to 7.3e-4,
#: 20 to 50 pixels of a 256² image)
LINE_SHARE_BOUND = 1e-3


@pytest.mark.parametrize("subject", ["bottle", "hazelnut", "carpet"])
def test_256_equals_declared_precision(subject):
    spec = syn.SynthSpec(subject=subject, imsize=(SIZE, SIZE))
    imgs, pool, masks, coords, counts = batch_inputs(BATCH, spec.is_non_fixed, SEED, size=SIZE)
    keys = jax.random.split(jax.random.key(SEED), BATCH)
    fn = jax.jit(js.batched_synthesizer(jax_spec(spec), per_image_masks=spec.is_non_fixed),
                 compiler_options={"xla_allow_excess_precision": False})
    jx, jy, _ = fn(keys, jnp.asarray(imgs), jnp.asarray(pool), jnp.int32(pool.shape[0]),
                   jnp.asarray(masks), jnp.asarray(coords), jnp.asarray(counts))
    draws = jr.jax_draws_np(spec, np.asarray(jax.random.key_data(keys)), pool.shape[0])
    x, y, _ = syn.synthesize(spec, draws, torch.from_numpy(imgs), torch.from_numpy(pool),
                             torch.from_numpy(masks), torch.from_numpy(coords),
                             torch.as_tensor(counts))
    jx, x = np.asarray(jx), x.numpy()
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    assert set(np.asarray(jy).tolist()) >= {1, 2, 3}
    assert x.shape == jx.shape == (BATCH, SIZE, SIZE, 3)
    assert np.array_equal(x, jx), f"{(x != jx).mean():.2e} of the values differ"


def _tpu_smooth_polyline(points, window: int = 10, polyorder: int = 2):
    """``ssad_tpu.ops.rasterize.smooth_polyline`` as a TPU runs its f32 dot
    at DEFAULT precision (scripts/tpu_precision_census.py: bf16 × bf16 →
    bf16 at ssad_tpu/ops/rasterize.py:152): operands rounded to bf16,
    summed in f32, the result rounded to bf16."""
    from ssad_tpu.ops import rasterize

    s = jnp.asarray(rasterize.savgol_matrix(points.shape[0], window, polyorder))
    out = jnp.dot(s.astype(jnp.bfloat16), points.astype(jnp.bfloat16),
                  preferred_element_type=jnp.float32)
    return out.astype(jnp.bfloat16).astype(jnp.float32)


def test_tpu_line_smoothing_rounding_measured(monkeypatch):
    """The TPU-only rounding the census flags in the synthesizer, measured
    on the CPU: with the line's Savitzky–Golay smoothing rounded as a TPU
    rounds it, only line samples (label 3) change, and each by a share of
    its values the port (f32 smoothing, as declared) does not reproduce."""
    from ssad_tpu.ops import rasterize

    spec = syn.SynthSpec(subject="bottle", imsize=(SIZE, SIZE))
    n = BATCH
    imgs, pool, masks, coords, counts = batch_inputs(n, False, SEED, size=SIZE)
    keys = jax.random.split(jax.random.key(SEED), n)
    monkeypatch.setattr(rasterize, "smooth_polyline", _tpu_smooth_polyline)
    fn = jax.jit(js.batched_synthesizer(jax_spec(spec), per_image_masks=False),
                 compiler_options={"xla_allow_excess_precision": False})
    tx, ty, _ = fn(keys, jnp.asarray(imgs), jnp.asarray(pool), jnp.int32(pool.shape[0]),
                   jnp.asarray(masks), jnp.asarray(coords), jnp.asarray(counts))
    draws = jr.jax_draws_np(spec, np.asarray(jax.random.key_data(keys)), pool.shape[0])
    x, y, _ = syn.synthesize(spec, draws, torch.from_numpy(imgs), torch.from_numpy(pool),
                             torch.from_numpy(masks), torch.from_numpy(coords),
                             torch.as_tensor(counts))
    tx, x, y = np.asarray(tx), x.numpy(), y.numpy()
    np.testing.assert_array_equal(y, np.asarray(ty))
    changed = (tx != x).reshape(n, -1).mean(axis=1)
    lines = y == 3
    assert lines.any() and not changed[~lines].any()
    print(f"TPU-rounded line smoothing: share of a line sample's values changed "
          f"{np.round(changed[lines], 5).tolist()}")
    assert (changed[lines] > 0).all() and changed[lines].max() <= LINE_SHARE_BOUND
