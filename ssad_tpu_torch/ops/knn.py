"""Batched k-NN cosine scoring: mean of the k smallest cosine distances.

Counterpart of ssad_tpu/ops/knn.py (l2_normalize, knn_cosine_scores_xla,
the resident Pallas kernel and the dispatch).  For unit vectors the
cosine distance is 1 − q·b, so the score is 1 − mean(top-k similarity).

* ``knn_cosine_scores_cuda`` launches the Hopper kernel of csrc/knn.cu
  (replacing the resident TPU kernel ``_knn_kernel``), for CUDA tensors.
* ``knn_cosine_scores_plain`` is the same function in plain PyTorch: an
  f32 matmul with TF32 off, then ``torch.topk``.  It serves CPU tensors,
  and the tests and the on-card check hold the kernel against it.
* ``knn_cosine_scores`` dispatches on the tensors' device.  There is no
  fallback: on a CUDA tensor the kernel runs or the call raises.

Scores stay f32 everywhere: they are 1 − cos with cos close to 1.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from ssad_tpu_torch.ops import _cuda

#: the kernel template covers 1 ≤ k ≤ MAX_K
MAX_K = 8
_QUERIES_PER_BLOCK = 8  # csrc/knn.cu kQueriesPerBlock
_WARPS = 8  # csrc/knn.cu kWarps


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    n = torch.sqrt(torch.sum(x * x, dim=dim, keepdim=True))
    return x / torch.clamp(n, min=eps)


@contextlib.contextmanager
def _tf32_off():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _check_args(queries: torch.Tensor, bank: torch.Tensor, k: int) -> None:
    if queries.ndim != 2 or bank.ndim != 2 or queries.shape[1] != bank.shape[1]:
        raise ValueError(
            f"expected queries (N, D) and bank (M, D), got "
            f"{tuple(queries.shape)} and {tuple(bank.shape)}"
        )
    if not 1 <= k <= bank.shape[0]:
        raise ValueError(f"k={k} must be in [1, M={bank.shape[0]}]")


def knn_cosine_scores_plain(queries: torch.Tensor, bank: torch.Tensor, k: int = 3) -> torch.Tensor:
    """Plain PyTorch version: (N, D), (M, D) → (N,) f32 scores."""
    _check_args(queries, bank, k)
    q = l2_normalize(queries.to(torch.float32))
    b = l2_normalize(bank.to(torch.float32))
    with _tf32_off():
        sims = q @ b.T
    top = torch.topk(sims, k, dim=1).values
    return 1.0 - top.mean(dim=1)


def _rows_per_split(n: int, m: int, device: torch.device) -> int:
    """Bank rows per stage-1 block: about two blocks per SM in all, with
    at least 4 rows per warp so the query staging stays amortised."""
    tiles = -(-n // _QUERIES_PER_BLOCK)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    rows = max(4 * _WARPS, -(-m * tiles // (2 * sms)))
    return -(-rows // _WARPS) * _WARPS


def knn_cosine_scores_cuda(queries: torch.Tensor, bank: torch.Tensor, k: int = 3) -> torch.Tensor:
    """Launch the CUDA kernel (csrc/knn.cu) on the current stream."""
    _check_args(queries, bank, k)
    if queries.device.type != "cuda" or bank.device != queries.device:
        raise ValueError(
            f"knn_cosine_scores_cuda needs both tensors on one CUDA device, "
            f"got {queries.device} and {bank.device}"
        )
    if k > MAX_K:
        raise ValueError(f"the CUDA kernel takes 1 <= k <= {MAX_K}, got k={k}")
    q = queries.to(torch.float32).contiguous()
    b = bank.to(torch.float32).contiguous()
    n, d = q.shape
    m = b.shape[0]
    out = torch.empty(n, dtype=torch.float32, device=q.device)
    if n == 0:
        return out
    rows = _rows_per_split(n, m, q.device)
    splits = -(-m // rows)
    partial = torch.empty((n, splits, k), dtype=torch.float32, device=q.device)
    fn = _kernel_fn()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        status = fn(
            q.data_ptr(), b.data_ptr(), partial.data_ptr(), out.data_ptr(),
            n, m, d, k, rows, splits, stream,
        )
    _cuda.check(status, "knn_cosine_scores_cuda")
    knn_cosine_scores_cuda.launches += 1
    return out


#: launches of the CUDA kernel since the last reset (one per call)
knn_cosine_scores_cuda.launches = 0


def _kernel_fn():
    fn = _cuda.load("knn").ssad_knn_cosine_scores
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    return fn


def knn_cosine_scores(queries: torch.Tensor, bank: torch.Tensor, k: int = 3) -> torch.Tensor:
    """CUDA tensors → the kernel; CPU tensors → the plain version."""
    if queries.device.type == "cuda":
        return knn_cosine_scores_cuda(queries, bank, k=k)
    if queries.device.type == "cpu" and bank.device.type == "cpu":
        return knn_cosine_scores_plain(queries, bank, k=k)
    raise ValueError(
        f"queries on {queries.device} and bank on {bank.device}: "
        "k-NN scoring runs on one CUDA device or on the CPU"
    )
