"""The CUDA k-NN kernel (ssad_tpu_torch/csrc/knn.cu) against its plain
PyTorch version, on the card.  Every test here takes the ``cuda_device``
fixture and skips where there is no card.

``_check`` calls the resident kernel's wrapper itself, so the kernel is
tested at any bank size; through ``knn_cosine_scores`` a bank above
1024 rows takes the tiled kernel (tests/test_torch_patch_cuda.py).

This file imports neither JAX nor the JAX package, so it also runs on a
machine without them:  python -m pytest --noconftest tests/test_torch_knn_cuda.py
Tolerance 1e-5 absolute: both sides compute f32 sims without TF32; the
gap is f32 summation order.
"""

import pytest
import torch
from _torch_port import cuda_device  # noqa: F401  (fixture)

from ssad_tpu_torch.ops import knn

ATOL = 1e-5


def _data(device, n, m, d, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn((n, d), generator=g, device=device),
            torch.randn((m, d), generator=g, device=device))


def _check(q, b, k):
    before = knn.knn_cosine_scores_cuda.launches
    out = knn.knn_cosine_scores_cuda(q, b, k=k)
    torch.cuda.synchronize()
    assert knn.knn_cosine_scores_cuda.launches == before + 1
    ref = knn.knn_cosine_scores_plain(q, b, k=k)
    assert out.shape == ref.shape and out.dtype == torch.float32
    assert torch.max(torch.abs(out - ref)).item() <= ATOL


@pytest.mark.parametrize(
    "n, m, d, k",
    [(8, 700, 512, 3), (300, 700, 512, 3), (37, 1000, 512, 1), (8, 20, 512, 3),
     (5, 3, 512, 3), (129, 4096, 512, 8), (3, 50, 100, 2)],
)
def test_kernel_matches_plain(cuda_device, n, m, d, k):  # noqa: F811
    _check(*_data(cuda_device, n, m, d, n + m), k)


def test_duplicate_rows_and_near_neighbours(cuda_device):  # noqa: F811
    base, _ = _data(cuda_device, 600, 1, 512, 1)
    q = base[:16] + 1e-3 * _data(cuda_device, 16, 1, 512, 2)[0]
    _check(q, torch.cat([base, base[:100]]), 3)
    # an exact neighbour scores (close to) zero
    out = knn.knn_cosine_scores(base[:4], base, k=1)
    assert torch.max(torch.abs(out)).item() <= 1e-6


def test_wide_rows_take_the_large_shared_memory_path(cuda_device):  # noqa: F811
    _check(*_data(cuda_device, 9, 64, 2048, 3), 3)  # 8 × 2048 × 4 B > 48 KB


def test_banks_above_1024_rows_dispatch_to_the_tiled_kernel(cuda_device):  # noqa: F811
    q, b = _data(cuda_device, 8, 4096, 512, 6)
    resident = knn.knn_cosine_scores_cuda.launches
    tiled = knn.knn_cosine_scores_tiled_cuda.launches
    knn.knn_cosine_scores(q, b, k=3)
    torch.cuda.synchronize()
    assert knn.knn_cosine_scores_tiled_cuda.launches == tiled + 1
    assert knn.knn_cosine_scores_cuda.launches == resident
    # a bank of exactly 1024 rows stays on the resident kernel
    knn.knn_cosine_scores(q, b[: knn.PALLAS_MAX_BANK_ROWS], k=3)
    torch.cuda.synchronize()
    assert knn.knn_cosine_scores_cuda.launches == resident + 1
    assert knn.knn_cosine_scores_tiled_cuda.launches == tiled + 1


def test_empty_queries_and_bad_k(cuda_device):  # noqa: F811
    q, b = _data(cuda_device, 0, 16, 512, 4)
    assert knn.knn_cosine_scores(q, b, k=3).shape == (0,)
    q, b = _data(cuda_device, 4, 16, 512, 5)
    with pytest.raises(ValueError, match="k"):
        knn.knn_cosine_scores(q, b, k=9)
