"""Window extraction in the port (ssad_tpu_torch/ops/patches.py) against
the JAX package's ops/patches.py on the same seeded images: the patches
must be equal element for element, in row-major window order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import seeded

from ssad_tpu.ops import patches as jpatches
from ssad_tpu_torch.ops import patches

torch.set_num_threads(1)


@pytest.mark.parametrize(
    "size, dim, stride",
    [(256, 32, 8), (64, 32, 8), (64, 16, 16), (50, 32, 6)],  # 50/32/6: dim % stride != 0
)
def test_extract_patches_matches_jax(size, dim, stride):
    x = seeded((2, size, size, 3), size + dim + stride)
    ref = np.asarray(jpatches.extract_patches(jnp.asarray(x), dim=dim, stride=stride))
    out = patches.extract_patches(torch.from_numpy(x), dim=dim, stride=stride).numpy()
    side = patches.grid_side(size, dim, stride)
    assert out.shape == (2, side * side, dim, dim, 3)
    np.testing.assert_array_equal(out, ref)
    if (size, dim, stride) == (256, 32, 8):
        assert side * side == 841


@pytest.mark.parametrize("h, w, dim, stride", [(256, 192, 32, 8), (64, 64, 32, 8), (50, 70, 32, 6)])
def test_grid_shape_matches_jax(h, w, dim, stride):
    assert patches.patch_grid_shape(h, w, dim, stride) == jpatches.patch_grid_shape(h, w, dim, stride)
    assert patches.grid_side(h, dim, stride) == jpatches.grid_side(h, dim, stride)
