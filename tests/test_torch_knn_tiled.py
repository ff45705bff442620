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


@pytest.mark.parametrize("d", [32, 100, 512])
def test_prepared_bank_is_the_jax_split_of_the_normalised_rows(d):
    """TiledBank's hi/lo are ssad_tpu's _split_bf16x2 of the same
    normalised rows, bit for bit, zero-padded to whole 64-deep slices."""
    rng = np.random.default_rng(d)
    bank = torch.from_numpy(rng.standard_normal((300, d)).astype(np.float32))
    prepared = knn.prepare_tiled_bank(bank)
    dp = -(-d // 64) * 64
    assert prepared.hi.shape == prepared.lo.shape == (300, dp) and prepared.dim == d
    assert prepared.shape == (300, d) and prepared.device == bank.device
    assert prepared.hi.is_contiguous() and prepared.lo.is_contiguous()
    unit = knn.l2_normalize(bank).numpy()
    jhi, jlo = jknn._split_bf16x2(jnp.asarray(unit))
    for ours, theirs in ((prepared.hi, jhi), (prepared.lo, jlo)):
        bits = ours[:, :d].view(torch.int16).numpy()
        np.testing.assert_array_equal(bits, np.asarray(theirs).view(np.int16))
        assert not torch.any(ours[:, d:].float())


@pytest.mark.parametrize("case", ["ragged", "duplicates"])
@pytest.mark.parametrize("k", [3, 1])
def test_plain_tiled_from_a_prepared_bank_is_bit_identical(case, k):
    q, bank = (torch.from_numpy(a) for a in _cases()[case])
    raw = knn.knn_cosine_scores_tiled_plain(q, bank, k=k)
    prepared = knn.knn_cosine_scores_tiled_plain(q, knn.prepare_tiled_bank(bank), k=k)
    assert torch.equal(raw, prepared)
    assert torch.equal(knn.knn_cosine_scores(q, knn.prepare_tiled_bank(bank), k=k), raw)


def test_dispatch_takes_a_prepared_bank_like_the_raw_one(monkeypatch):
    calls = []

    def sentinel(name):
        def fn(queries, bank, k=3):
            calls.append((name, type(bank).__name__))
            raise AssertionError(name)
        return fn

    for name in ("knn_cosine_scores_plain", "knn_cosine_scores_tiled_plain",
                 "knn_cosine_scores_cuda", "knn_cosine_scores_tiled_cuda"):
        monkeypatch.setattr(knn, name, sentinel(name))
    rng = np.random.default_rng(3)
    big = torch.from_numpy(rng.random((knn.PALLAS_MAX_BANK_ROWS + 1, 8), dtype=np.float32))
    q = torch.from_numpy(rng.random((4, 8), dtype=np.float32))
    for bank in (big, knn.prepare_tiled_bank(big)):
        with pytest.raises(AssertionError, match="knn_cosine_scores_tiled_plain"):
            knn.knn_cosine_scores(q, bank, k=3)
    assert calls == [("knn_cosine_scores_tiled_plain", "Tensor"),
                     ("knn_cosine_scores_tiled_plain", "TiledBank")]
    # a bank the f32 function serves has no prepared form
    with pytest.raises(ValueError, match="TiledBank"):
        knn.knn_cosine_scores(q, knn.prepare_tiled_bank(big[:knn.PALLAS_MAX_BANK_ROWS]), k=3)


def test_prepare_bank_changes_nothing_on_the_cpu():
    """Only a CUDA bank the tiled kernel serves is prepared; on the CPU the
    plain versions take the raw bank."""
    bank = torch.ones((knn.PALLAS_MAX_BANK_ROWS + 1, 8))
    small = bank[:10]
    assert knn.prepare_bank(bank) is bank and knn.prepare_bank(small) is small
    with pytest.raises(ValueError, match="CUDA"):
        knn.knn_cosine_scores_tiled_cuda(torch.ones((4, 8)), knn.prepare_tiled_bank(bank), k=3)
