"""The bf16x3 k-NN function of the port (knn_cosine_scores_tiled_plain,
the plain version of csrc/knn_tiled.cu) against the JAX package's
streaming Pallas kernel in interpret mode and its f32 XLA oracle, and
the dispatch by bank size.

Tolerances: 2e-6 against the Pallas kernel (the same bf16x3 products;
measured 4.5e-7, f32 summation order), 3e-5 against the f32 oracle (the
dropped ql·bl term and the 2⁻¹⁶ split, as the JAX tests state).
The CUDA kernel's own tests are in tests/test_torch_patch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssad_tpu.ops import knn as jknn
from ssad_tpu_torch.ops import knn

torch.set_num_threads(1)


def test_split_is_exact():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    hi, lo = knn.split_bf16x2(x)
    assert hi.dtype == lo.dtype == torch.bfloat16
    assert torch.all((hi.float().view(torch.int32) & 0xFFFF) == 0)
    err = torch.abs(hi.float() + lo.float() - x) / torch.abs(x)
    assert err.max().item() <= 2.0**-16


def _cases():
    rng = np.random.default_rng(0)
    bank = rng.random((2500, 32), dtype=np.float32)  # a ragged last 1024-row tile
    q = rng.random((40, 32), dtype=np.float32)
    base = rng.random((1500, 32)).astype(np.float32)
    dup_bank = np.concatenate([base, base[:200]])  # duplicates in tiles 0 and 1
    dup_q = base[:16] + 1e-3 * rng.standard_normal((16, 32)).astype(np.float32)
    return {"ragged": (q, bank), "duplicates": (dup_q, dup_bank)}


@pytest.mark.parametrize("case", ["ragged", "duplicates"])
@pytest.mark.parametrize("k", [3, 1])
def test_plain_tiled_matches_pallas_interpret_and_xla(case, k):
    from jax.experimental.pallas import tpu as pltpu

    q, bank = _cases()[case]
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jknn.knn_cosine_scores_pallas_tiled(jnp.asarray(q), jnp.asarray(bank), k=k))
    oracle = np.asarray(jknn.knn_cosine_scores_xla(jnp.asarray(q), jnp.asarray(bank), k=k))
    out = knn.knn_cosine_scores_tiled_plain(torch.from_numpy(q), torch.from_numpy(bank), k=k)
    assert out.dtype == torch.float32 and out.shape == (q.shape[0],)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-6, rtol=0)
    np.testing.assert_allclose(out.numpy(), oracle, atol=3e-5, rtol=0)


def test_dispatch_by_bank_size(monkeypatch):
    """Above PALLAS_MAX_BANK_ROWS the bf16x3 function serves, at or below
    it the f32 one (the JAX package's _pallas_kernel_for); the card tests
    check the same split between the two CUDA kernels."""
    calls = []

    def sentinel(name):
        def fn(*a, **kw):
            calls.append(name)
            raise AssertionError(name)
        return fn

    for name in ("knn_cosine_scores_plain", "knn_cosine_scores_tiled_plain",
                 "knn_cosine_scores_cuda", "knn_cosine_scores_tiled_cuda"):
        monkeypatch.setattr(knn, name, sentinel(name))
    assert knn.PALLAS_MAX_BANK_ROWS == jknn.PALLAS_MAX_BANK_ROWS == 1024
    rng = np.random.default_rng(1)
    big = torch.from_numpy(rng.random((knn.PALLAS_MAX_BANK_ROWS + 1, 8), dtype=np.float32))
    q = torch.from_numpy(rng.random((4, 8), dtype=np.float32))
    with pytest.raises(AssertionError, match="knn_cosine_scores_tiled_plain"):
        knn.knn_cosine_scores(q, big, k=3)
    with pytest.raises(AssertionError, match="knn_cosine_scores_plain"):
        knn.knn_cosine_scores(q, big[: knn.PALLAS_MAX_BANK_ROWS], k=3)
    assert calls == ["knn_cosine_scores_tiled_plain", "knn_cosine_scores_plain"]


def test_large_bank_on_the_cpu_is_the_tiled_function():
    rng = np.random.default_rng(2)
    bank = torch.from_numpy(rng.standard_normal((1100, 16)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((6, 16)).astype(np.float32))
    assert torch.equal(knn.knn_cosine_scores(q, bank, k=3),
                       knn.knn_cosine_scores_tiled_plain(q, bank, k=3))


def test_cuda_wrappers_refuse_cpu_tensors():
    q, b = torch.ones((4, 8)), torch.ones((2000, 8))
    with pytest.raises(ValueError, match="CUDA"):
        knn.knn_cosine_scores_tiled_cuda(q, b, k=3)
    with pytest.raises(ValueError, match="CUDA"):
        knn.knn_cosine_scores_cuda(q, b, k=3)
    with pytest.raises(ValueError, match="k="):
        knn.knn_cosine_scores_tiled_plain(q, b[:2], k=3)
