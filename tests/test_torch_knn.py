"""k-NN cosine scoring in the port (ssad_tpu_torch/ops/knn.py) against the
JAX package's XLA function, its resident Pallas kernel in interpret mode
and sklearn, on the same seeded inputs.  Tolerance 1e-5 absolute: both
sides compute f32 sims at full precision, so the gap is f32 summation
order (measured ≤ 2e-7).

The CUDA kernel's own tests are in tests/test_torch_knn_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssad_tpu.ops import knn as jknn
from ssad_tpu_torch.ops import knn

torch.set_num_threads(1)
ATOL = 1e-5


def _plain(q, b, k):
    return knn.knn_cosine_scores(torch.from_numpy(q), torch.from_numpy(b), k=k).numpy()


@pytest.mark.parametrize(
    "n, m, d, k",
    [(50, 200, 64, 3), (8, 700, 512, 3), (37, 100, 32, 1), (5, 130, 16, 8)],
)
def test_plain_matches_xla(n, m, d, k):
    rng = np.random.default_rng(n * 1000 + m)
    q = rng.standard_normal((n, d)).astype(np.float32)
    b = rng.standard_normal((m, d)).astype(np.float32)
    ref = np.asarray(jknn.knn_cosine_scores_xla(jnp.asarray(q), jnp.asarray(b), k=k))
    np.testing.assert_allclose(_plain(q, b, k), ref, atol=ATOL, rtol=0)


def test_plain_matches_sklearn():
    from sklearn.neighbors import NearestNeighbors

    rng = np.random.default_rng(0)
    bank = rng.random((200, 64), dtype=np.float32)
    q = rng.random((50, 64), dtype=np.float32)
    ref = NearestNeighbors(n_neighbors=3, metric="cosine").fit(bank).kneighbors(q)[0]
    np.testing.assert_allclose(_plain(q, bank, 3), ref.mean(axis=1), atol=ATOL, rtol=0)


@pytest.mark.parametrize("m", [100, 37])  # 37: a bank short of a 128 lane tile
def test_plain_matches_pallas_interpret(m):
    from jax.experimental.pallas import tpu as pltpu

    rng = np.random.default_rng(m)
    bank = rng.random((m, 32), dtype=np.float32)
    q = rng.random((40, 32), dtype=np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = jknn.knn_cosine_scores_pallas(jnp.asarray(q), jnp.asarray(bank), k=3)
    np.testing.assert_allclose(_plain(q, bank, 3), np.asarray(ref), atol=ATOL, rtol=0)


def test_duplicate_bank_rows_count_separately():
    """Bit-identical bank rows each count toward the top-k, as in the
    TPU kernel (tests/test_ops.py::test_pallas_counts_duplicate_bank_rows_like_topk)."""
    from jax.experimental.pallas import tpu as pltpu

    rng = np.random.default_rng(0)
    base = rng.random((20, 32)).astype(np.float32)
    bank = np.concatenate([base, base[:5]])  # 5 duplicates
    q = base[:8] + 1e-3 * rng.standard_normal((8, 32)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jknn.knn_cosine_scores_pallas(jnp.asarray(q), jnp.asarray(bank), k=3))
    ours = _plain(q, bank, 3)
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=0)
    # masking every tie instead would pull in the 3rd distinct row
    assert ours[0] < _plain(q[:1], base, 3)[0]


def test_exact_neighbor_scores_zero():
    bank = np.eye(8, dtype=np.float32)
    np.testing.assert_allclose(_plain(bank[:2], bank, 1), 0.0, atol=1e-6)


def test_k_out_of_range_raises():
    q = torch.zeros((2, 4))
    with pytest.raises(ValueError, match="k="):
        knn.knn_cosine_scores(q, torch.ones((2, 4)), k=3)


def test_no_silent_cpu_compute_for_other_devices():
    """A tensor that is not on the CPU never reaches the plain version;
    the kernel wrapper refuses anything but CUDA tensors."""
    q = torch.empty((4, 8), device="meta")
    b = torch.empty((16, 8), device="meta")
    with pytest.raises(ValueError):
        knn.knn_cosine_scores(q, b, k=3)
    with pytest.raises(ValueError, match="CUDA"):
        knn.knn_cosine_scores_cuda(torch.ones((4, 8)), torch.ones((16, 8)), k=3)
    with pytest.raises(ValueError):
        knn.knn_cosine_scores(torch.ones((4, 8)), b, k=3)
