"""The CUDA kernels of the patch path against their plain PyTorch
versions, on the card: the fused stem (csrc/stem_pool.cu) and the
streaming bf16x3 k-NN (csrc/knn_tiled.cu).  Every test takes the
``cuda_device`` fixture and skips where there is no card.

This file imports neither JAX nor the JAX package, so it runs on a
machine without them:
    python -m pytest --noconftest tests/test_torch_patch_cuda.py
Tolerances:
* stem: rtol 2⁻⁷ / atol 1e-6 (one bf16 ulp), with fewer than 1e-3 of the
  elements not bit-equal — the f32 sums of 48 taps run in another order
  than the plain matmul's, which can flip a value next to a rounding
  boundary;
* k-NN: 1e-5 absolute against the plain bf16x3 version (the same
  products, f32 summation order), 3e-5 against the f32 function (the
  split's 2⁻¹⁶ and the dropped ql·bl term); a raw bank and its TiledBank
  give the same bits.
"""

import pytest
import torch
from _torch_port import cuda_device  # noqa: F401  (fixture)

from ssad_tpu_torch.ops import knn, stem_pool

BF16_RTOL, BF16_ATOL, MAX_FLIPPED = 2.0**-7, 1e-6, 1e-3
KNN_TOL, KNN_F32_TOL = 1e-5, 3e-5


def _stem_inputs(device, n, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    x = (2 * torch.rand((n, 32, 32, 3), generator=g, device=device) - 1).to(torch.bfloat16)
    k4 = 0.3 * torch.randn((4, 4, 3, 64), generator=g, device=device)
    scale = 0.5 + torch.rand(64, generator=g, device=device)
    bias = 0.1 * torch.randn(64, generator=g, device=device)
    return x, k4, scale, bias


def check_stem(x, k4, scale, bias):
    before = stem_pool.stem_pool_cuda.launches
    out = stem_pool.stem_pool(x, k4, scale, bias)
    torch.cuda.synchronize()
    assert stem_pool.stem_pool_cuda.launches == before + 1
    ref = stem_pool.stem_pool_plain(x, k4, scale, bias)
    assert out.shape == ref.shape == (x.shape[0], 16, 16, 64) and out.dtype == torch.bfloat16
    o, r = out.float(), ref.float()
    assert torch.allclose(o, r, rtol=BF16_RTOL, atol=BF16_ATOL)
    assert (o != r).float().mean().item() < MAX_FLIPPED
    return out


@pytest.mark.parametrize("n", [1, 9, 841, 6728])
def test_stem_kernel_matches_plain(cuda_device, n):  # noqa: F811
    check_stem(*_stem_inputs(cuda_device, n, n))


def test_stem_kernel_band_halos_and_conv_padding(cuda_device):  # noqa: F811
    """Large values on the patch's border rows and columns and on the rows
    where the kernel's 8-row bands meet: the conv's zero padding and the
    halo row a band takes from the one before both decide pooled outputs."""
    x, k4, scale, bias = _stem_inputs(cuda_device, 7, 11)
    x = x.clone()
    x[:, 0] = 24.0
    x[:, 31] = -24.0
    x[:, :, 0] = 16.0
    x[:, :, 31] = 20.0
    x[:, 7::8] *= 12.0  # the last row of every band: a halo of the next
    x[2:4] = -x[2:4]
    check_stem(x, k4, scale, bias)


def test_stem_kernel_pools_zero_padding_and_refuses_bad_input(cuda_device):  # noqa: F811
    x, k4, scale, bias = _stem_inputs(cuda_device, 3, 7)
    # a negative bias makes most conv outputs zero after the ReLU
    out = check_stem(x, k4, scale, bias - 10.0)
    assert torch.all(out >= 0)
    with pytest.raises(ValueError, match="bfloat16"):
        stem_pool.stem_pool_cuda(x.float(), k4, scale, bias)
    with pytest.raises(ValueError, match="64"):
        stem_pool.stem_pool_cuda(x, k4[..., :32], scale[:32], bias[:32])


def _knn_data(device, n, m, d, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn((n, d), generator=g, device=device),
            torch.randn((m, d), generator=g, device=device))


def check_tiled(q, b, k):
    """The kernel from the raw bank and from its TiledBank (the same bits)
    against the plain bf16x3 version and the f32 function."""
    before = knn.knn_cosine_scores_tiled_cuda.launches
    out = knn.knn_cosine_scores_tiled_cuda(q, b, k=k)
    torch.cuda.synchronize()
    assert knn.knn_cosine_scores_tiled_cuda.launches == before + 1
    prepared = knn.knn_cosine_scores_tiled_cuda(q, knn.prepare_tiled_bank(b), k=k)
    torch.cuda.synchronize()
    assert torch.equal(out, prepared)
    ref = knn.knn_cosine_scores_tiled_plain(q, b, k=k)
    assert out.shape == ref.shape and out.dtype == torch.float32
    assert torch.max(torch.abs(out - ref)).item() <= KNN_TOL
    f32 = knn.knn_cosine_scores_plain(q, b, k=k)
    assert torch.max(torch.abs(out - f32)).item() <= KNN_F32_TOL


@pytest.mark.parametrize(
    "n, m, d, k",
    [(40, 2500, 32, 3), (40, 2500, 32, 1), (841, 5000, 512, 3), (3, 1030, 100, 8),
     (130, 129, 512, 3), (6728, 29435, 512, 3)],
)
def test_tiled_kernel_matches_plain(cuda_device, n, m, d, k):  # noqa: F811
    check_tiled(*_knn_data(cuda_device, n, m, d, n + m), k)


def test_tiled_kernel_counts_duplicates_across_tiles_and_splits(cuda_device):  # noqa: F811
    base, _ = _knn_data(cuda_device, 5000, 1, 512, 1)
    q = base[:16] + 1e-3 * _knn_data(cuda_device, 16, 1, 512, 2)[0]
    # rows 0..299 again at the end: another 128-row tile and another split
    check_tiled(q, torch.cat([base, base[:300]]), 3)


@pytest.mark.parametrize("k", [1, 3])
def test_tiled_kernel_near_duplicates_at_cos_one(cuda_device, k):  # noqa: F811
    """Queries are bank rows plus 1e-4 noise, so each query's best
    similarity is within ~1e-8 of 1: the regime where the tensor cores'
    own f32 accumulation lost low bits (the kernel adds each 64-deep
    group's fresh accumulator into the running sum with IEEE adds)."""
    bank, _ = _knn_data(cuda_device, 29435, 1, 512, 3)
    q = bank[:841] + 1e-4 * _knn_data(cuda_device, 841, 1, 512, 4)[0]
    check_tiled(q, bank, k)


def test_tiled_kernel_back_to_back_calls_are_bit_identical(cuda_device):  # noqa: F811
    q, b = _knn_data(cuda_device, 6728, 29435, 512, 5)
    prepared = knn.prepare_tiled_bank(b)
    first = knn.knn_cosine_scores_tiled_cuda(q, prepared, k=3)
    second = knn.knn_cosine_scores_tiled_cuda(q, prepared, k=3)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert torch.equal(first, knn.knn_cosine_scores(q, prepared, k=3))
