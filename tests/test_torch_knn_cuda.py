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
     (5, 3, 512, 3), (129, 4096, 512, 8), (3, 50, 100, 2),
     # banks smaller than a full cluster, under several query tiles
     (300, 20, 512, 3), (9, 3, 100, 3),
     # a bank that is not a multiple of the rows per CTA (96; last CTA 41)
     (37, 1001, 512, 8)],
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
    # 2048-wide rows: the kernel streams D in slices, so shared memory does
    # not grow with D (the plan's bytes are checked in test_torch_knn_plan.py)
    _check(*_data(cuda_device, 9, 64, 2048, 3), 3)


def test_odd_depth_and_unaligned_rows_are_padded(cuda_device):  # noqa: F811
    # the kernel copies 16-byte pieces: D = 98 and a view that starts one
    # float into its storage both go through a zero-padded copy
    q, b = _data(cuda_device, 6, 90, 98, 10)
    _check(q, b, 3)
    flat = torch.randn(1 + 6 * 64, device=cuda_device)
    _check(flat[1:].view(6, 64), b[:, :64].contiguous(), 2)


def test_one_kernel_launch_per_call(cuda_device):  # noqa: F811
    from torch.profiler import ProfilerActivity, profile

    q, b = _data(cuda_device, 300, 700, 512, 8)
    knn.knn_cosine_scores_cuda(q, b, k=3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            knn.knn_cosine_scores_cuda(q, b, k=3)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 3 and all("knn_cluster_kernel" in name for name in kernels), kernels


def test_back_to_back_calls_are_bit_identical(cuda_device):  # noqa: F811
    for n, m in ((8, 700), (300, 700), (5, 3)):
        q, b = _data(cuda_device, n, m, 512, 9)
        first = knn.knn_cosine_scores_cuda(q, b, k=3)
        second = knn.knn_cosine_scores_cuda(q, b, k=3)
        torch.cuda.synchronize()
        assert torch.equal(first, second)


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
