"""Batched k-NN cosine scoring: mean of the k smallest cosine distances.

Counterpart of ssad_tpu/ops/knn.py (l2_normalize, knn_cosine_scores_xla,
both Pallas kernels and the dispatch).  For unit vectors the cosine
distance is 1 − q·b, so the score is 1 − mean(top-k similarity).

Two functions, as in the JAX package, chosen by bank size:

* banks of at most ``PALLAS_MAX_BANK_ROWS`` rows: IEEE f32 similarities.
  ``knn_cosine_scores_cuda`` launches csrc/knn.cu (replacing the
  resident TPU kernel ``_knn_kernel``); ``knn_cosine_scores_plain`` is an
  f32 matmul with TF32 off, then ``torch.topk``.
* larger banks: bf16x3 similarities (each unit vector split into a
  bit-masked bf16 hi/lo pair, qh·bh + qh·bl + ql·bh in f32).
  ``knn_cosine_scores_tiled_cuda`` launches csrc/knn_tiled.cu (replacing
  the streaming TPU kernel ``_knn_tiled_kernel``);
  ``knn_cosine_scores_tiled_plain`` is three f32 matmuls with TF32 off,
  then ``torch.topk``.  A fitted bank is normalised and split once into
  a ``TiledBank`` (``prepare_bank``), which both take in place of the
  raw bank.

The plain versions serve CPU tensors, and the tests and the on-card check
hold each kernel against its plain version.  ``knn_cosine_scores``
dispatches on the bank's size and the tensors' device; there is no
fallback: on a CUDA tensor a kernel runs or the call raises.

Scores stay f32 everywhere: they are 1 − cos with cos close to 1.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ssad_tpu_torch.ops import _cuda
from ssad_tpu_torch.utils.device import tf32_off

#: the kernels take 1 ≤ k ≤ MAX_K
MAX_K = 8
MAX_CLUSTER = 16  # CTAs per query tile of csrc/knn.cu (non-portable cluster size)
_CHUNK_ROWS = 48  # csrc/knn.cu kBM
_STAGES = 3  # csrc/knn.cu kStages
_PARTIAL_ROWS = 256  # csrc/knn.cu Tile<BQ>::KS * BQ: depth groups x queries
_TILE_Q = 128  # csrc/knn_tiled.cu kBQ
_TILE_M = 128  # csrc/knn_tiled.cu kBN
_TILE_D = 64  # csrc/knn_tiled.cu kBK: the depth is zero-padded to a multiple

#: banks above this many rows take the bf16x3 streaming function (the
#: JAX package's resident↔tiled crossover, ssad_tpu/ops/knn.py:329)
PALLAS_MAX_BANK_ROWS = 1024


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    n = torch.sqrt(torch.sum(x * x, dim=dim, keepdim=True))
    return x / torch.clamp(n, min=eps)


def _check_args(queries: torch.Tensor, bank, k: int) -> None:
    if queries.ndim != 2 or len(bank.shape) != 2 or queries.shape[1] != bank.shape[1]:
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
    with tf32_off():
        sims = q @ b.T
    top = torch.topk(sims, k, dim=1).values
    return 1.0 - top.mean(dim=1)


class KnnPlan(NamedTuple):
    """Launch plan of csrc/knn.cu: one cluster of ``cluster`` CTAs per
    tile of ``query_tile`` queries, each CTA ``rows_per_cta`` bank rows."""

    query_tile: int
    cluster: int
    rows_per_cta: int
    tiles: int
    smem_bytes: int  # dynamic + static shared memory per CTA


@functools.lru_cache(maxsize=256)
def _plan(n: int, m: int, d: int) -> KnnPlan:
    """The launch plan for N queries against M bank rows of depth D.

    The query tile follows N (the image path's request batch is 8, its
    fit 300).  The bank goes across up to MAX_CLUSTER CTAs (at D = 512 a
    700-row bank is 44 rows, 88 KB, per CTA); a share above one 48-row
    chunk is rounded up to whole chunks.  D is streamed in slices, so
    shared memory does not grow with it."""
    if n < 1 or m < 1 or d < 1:
        raise ValueError(f"empty k-NN problem: N={n}, M={m}, D={d}")
    bq = 8 if n <= 8 else 16 if n <= 16 else 32
    tiles = -(-n // bq)
    rows = -(-m // MAX_CLUSTER)
    if rows > _CHUNK_ROWS:
        rows = -(-rows // _CHUNK_ROWS) * _CHUNK_ROWS
    slice_depth = 8 * _PARTIAL_ROWS // bq  # Tile<BQ>::BK: 8 floats per depth group
    stages = _STAGES * (bq + _CHUNK_ROWS) * (slice_depth + 4)
    partial_sums = _PARTIAL_ROWS * (_CHUNK_ROWS + 1)  # aliases the stages
    dynamic = 4 * max(stages, partial_sums)
    static = 4 * (bq + _CHUNK_ROWS + MAX_CLUSTER * bq * MAX_K)
    return KnnPlan(bq, -(-m // rows), rows, tiles, dynamic + static)


def knn_cosine_scores_cuda(queries: torch.Tensor, bank: torch.Tensor, k: int = 3) -> torch.Tensor:
    """Launch the CUDA kernel (csrc/knn.cu) on the current stream: one
    launch, nothing allocated but the (N,) output."""
    _check_args(queries, bank, k)
    if queries.device.type != "cuda" or bank.device != queries.device:
        raise ValueError(
            f"knn_cosine_scores_cuda needs both tensors on one CUDA device, "
            f"got {queries.device} and {bank.device}"
        )
    if k > MAX_K:
        raise ValueError(f"the CUDA kernel takes 1 <= k <= {MAX_K}, got k={k}")
    q, b = _f32_contiguous(queries), _f32_contiguous(bank)
    n, d = q.shape
    m = b.shape[0]
    out = torch.empty(n, dtype=torch.float32, device=q.device)
    if n == 0:
        return out
    if d % 4 or q.data_ptr() % 16 or b.data_ptr() % 16:
        # the kernel copies 16-byte pieces; zero columns change no dot product or norm
        q = torch.nn.functional.pad(q, (0, -d % 4))
        b = torch.nn.functional.pad(b, (0, -d % 4))
        d = q.shape[1]
    plan = _plan(n, m, d)
    device = q.device.index if q.device.index is not None else torch.cuda.current_device()
    status = _kernel_fn()(
        q.data_ptr(), b.data_ptr(), out.data_ptr(), n, m, d, k,
        plan.query_tile, plan.cluster, plan.rows_per_cta, device,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _cuda.check(status, "knn_cosine_scores_cuda")
    knn_cosine_scores_cuda.launches += 1
    return out


#: launches of the CUDA kernel since the last reset (one per call)
knn_cosine_scores_cuda.launches = 0


def _f32_contiguous(x: torch.Tensor) -> torch.Tensor:
    # skips two no-op calls per operand on the served path's host time
    if x.dtype == torch.float32 and x.is_contiguous():
        return x
    return x.to(torch.float32).contiguous()


def _kernel_fn():
    return _cuda.bind("knn", "ssad_knn_cosine_scores",
                      [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p])


def knn_active_clusters(n: int, m: int, d: int, device: torch.device) -> int:
    """How many of the plan's clusters the card holds at once (the CUDA
    occupancy calculator); for the on-card records."""
    plan = _plan(n, m, d)
    index = device.index if device.index is not None else torch.cuda.current_device()
    fn = _cuda.bind("knn", "ssad_knn_occupancy",
                    [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)])
    active = ctypes.c_int(0)
    _cuda.check(fn(plan.query_tile, plan.cluster, index, ctypes.byref(active)),
                "knn_active_clusters")
    return active.value


def split_bf16x2(x: torch.Tensor):
    """f32 → (hi, lo) bf16 pair with hi + lo ≈ x to ~2⁻¹⁶ relative: hi is
    x with the low 16 bits of its pattern cleared (exact in bf16), lo is
    bf16(x − hi), where x − hi is exact in f32 (ssad_tpu/ops/knn.py:149)."""
    x = x.to(torch.float32).contiguous()
    hi = (x.view(torch.int32) & -65536).view(torch.float32)
    return hi.to(torch.bfloat16), (x - hi).to(torch.bfloat16)


class TiledBank(NamedTuple):
    """A bank prepared once for the bf16x3 function: its L2-normalised
    rows split into bf16 ``hi``/``lo`` (``split_bf16x2``), the depth
    zero-padded to a multiple of the kernel's 64-deep slices.  A fitted
    bank is fixed for an artifact's life, so the served path builds this
    once (``prepare_bank``) instead of on every call."""

    hi: torch.Tensor  # (M, Dp) bf16
    lo: torch.Tensor  # (M, Dp) bf16
    dim: int  # D before padding

    @property
    def shape(self):
        return (self.hi.shape[0], self.dim)

    @property
    def device(self) -> torch.device:
        return self.hi.device


def prepare_tiled_bank(bank: torch.Tensor) -> TiledBank:
    """(M, D) bank → its TiledBank, on the bank's device."""
    if bank.ndim != 2:
        raise ValueError(f"expected a bank (M, D), got {tuple(bank.shape)}")
    return TiledBank(*_split_padded(bank), bank.shape[1])


def prepare_bank(bank: torch.Tensor):
    """The form of a fitted bank that k-NN scoring takes fastest on its
    device: a TiledBank where csrc/knn_tiled.cu serves it (a CUDA bank of
    more than PALLAS_MAX_BANK_ROWS rows), else the bank itself."""
    if bank.device.type == "cuda" and bank.shape[0] > PALLAS_MAX_BANK_ROWS:
        return prepare_tiled_bank(bank)
    return bank


def knn_cosine_scores_tiled_plain(queries: torch.Tensor, bank, k: int = 3) -> torch.Tensor:
    """Plain PyTorch version of the bf16x3 function: (N, D) queries and an
    (M, D) bank or its TiledBank → (N,) f32 scores, the same bits from
    either form of the bank."""
    _check_args(queries, bank, k)
    qh, ql = (t.float() for t in split_bf16x2(l2_normalize(queries.to(torch.float32))))
    if isinstance(bank, TiledBank):
        bh, bl = (t[:, : bank.dim].float().contiguous() for t in (bank.hi, bank.lo))
    else:
        bh, bl = (t.float() for t in split_bf16x2(l2_normalize(bank.to(torch.float32))))
    with tf32_off():
        sims = qh @ bh.T
        sims += qh @ bl.T
        sims += ql @ bh.T
    top = torch.topk(sims, k, dim=1).values
    return 1.0 - top.mean(dim=1)


def _split_padded(x: torch.Tensor):
    """Normalise, split and zero-pad the depth to a multiple of _TILE_D."""
    hi, lo = split_bf16x2(l2_normalize(x.to(torch.float32)))
    pad = -x.shape[1] % _TILE_D
    if pad:
        hi = torch.nn.functional.pad(hi, (0, pad))
        lo = torch.nn.functional.pad(lo, (0, pad))
    return hi.contiguous(), lo.contiguous()


class TiledPlan(NamedTuple):
    """Launch plan of csrc/knn_tiled.cu: a grid of ``query_tiles`` ×
    ``splits`` CTAs (query tiles fastest), each walking
    ``tiles_per_split`` of the ``bank_tiles`` tiles of ``_TILE_M`` rows
    (the last split fewer)."""

    query_tiles: int
    bank_tiles: int
    tiles_per_split: int
    splits: int


def _makespan(jobs, sms: int) -> float:
    """Finish time of ``jobs`` — (count, duration) runs in launch order —
    handed one at a time to the earliest free of ``sms`` SMs."""
    free = {0.0: sms}  # time an SM frees up → how many SMs free up then
    for count, duration in jobs:
        while count:
            t = min(free)
            take = min(free[t], count)
            free[t] -= take
            if not free[t]:
                del free[t]
            free[t + duration] = free.get(t + duration, 0) + take
            count -= take
    return max(free)


@functools.lru_cache(maxsize=256)
def _tiled_plan(n: int, m: int, d: int, sms: int) -> TiledPlan:
    """The splits of the bank for N queries against M rows of depth D on
    ``sms`` SMs, one CTA per SM.

    A CTA costs its tiles' 64-deep slices plus one slice for filling its
    ring and writing its partial top-k; CTAs go to SMs in launch order as
    SMs free up.  Of all split counts the one with the earliest finish
    wins (the fewest splits among equals).  At the patch path's request
    shape, 53 query tiles × 230 bank tiles on 132 SMs, that is 15 splits
    of 16 tiles in 7 waves, with 4 % of the SMs' time idle."""
    if n < 1 or m < 1 or d < 1 or sms < 1:
        raise ValueError(f"empty k-NN problem: N={n}, M={m}, D={d}, SMs={sms}")
    q_tiles, m_tiles = -(-n // _TILE_Q), -(-m // _TILE_M)
    slices = -(-d // _TILE_D)
    best = None
    for per_split in sorted({-(-m_tiles // s) for s in range(1, m_tiles + 1)}, reverse=True):
        span = _makespan(_tiled_jobs(q_tiles, m_tiles, per_split, slices), sms)
        if best is None or span < best[0]:
            best = (span, per_split)
    per_split = best[1]
    return TiledPlan(q_tiles, m_tiles, per_split, -(-m_tiles // per_split))


def _tiled_jobs(q_tiles: int, m_tiles: int, per_split: int, slices: int):
    """The plan's CTAs as (count, duration) runs in launch order: each
    costs its tiles' 64-deep slices plus one for its fill and write-out."""
    splits = -(-m_tiles // per_split)
    last = m_tiles - (splits - 1) * per_split
    return [(q_tiles * (splits - 1), per_split * slices + 1), (q_tiles, last * slices + 1)]


@functools.lru_cache(maxsize=16)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def knn_cosine_scores_tiled_cuda(queries: torch.Tensor, bank, k: int = 3) -> torch.Tensor:
    """Launch the CUDA kernel (csrc/knn_tiled.cu) on the current stream.
    ``bank`` is an (M, D) tensor or its TiledBank; a raw bank is
    normalised and split here on every call, the queries always are (as
    the JAX package runs both in XLA outside its kernel)."""
    _check_args(queries, bank, k)
    if queries.device.type != "cuda" or bank.device != queries.device:
        raise ValueError(
            f"knn_cosine_scores_tiled_cuda needs both tensors on one CUDA device, "
            f"got {queries.device} and {bank.device}"
        )
    if k > MAX_K:
        raise ValueError(f"the CUDA kernel takes 1 <= k <= {MAX_K}, got k={k}")
    n, m = queries.shape[0], bank.shape[0]
    out = torch.empty(n, dtype=torch.float32, device=queries.device)
    if n == 0:
        return out
    if not isinstance(bank, TiledBank):
        bank = prepare_tiled_bank(bank)
    qh, ql = _split_padded(queries)
    dp = qh.shape[1]
    device = queries.device.index if queries.device.index is not None else torch.cuda.current_device()
    plan = _tiled_plan(n, m, dp, _sm_count(device))
    partial = torch.empty((n, plan.splits, k), dtype=torch.float32, device=queries.device)
    status = _tiled_kernel_fn()(
        qh.data_ptr(), ql.data_ptr(), bank.hi.data_ptr(), bank.lo.data_ptr(),
        partial.data_ptr(), out.data_ptr(), n, m, dp, k, plan.tiles_per_split, plan.splits,
        device, torch.cuda.current_stream(queries.device).cuda_stream,
    )
    _cuda.check(status, "knn_cosine_scores_tiled_cuda")
    knn_cosine_scores_tiled_cuda.launches += 1
    return out


#: launches of the CUDA kernel since the last reset (one per call)
knn_cosine_scores_tiled_cuda.launches = 0


def _tiled_kernel_fn():
    return _cuda.bind("knn_tiled", "ssad_knn_tiled_scores",
                      [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p])


def knn_tiled_resident_ctas(device: torch.device) -> int:
    """CTAs of csrc/knn_tiled.cu resident per SM (the CUDA occupancy
    calculator); for the on-card records."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    fn = _cuda.bind("knn_tiled", "ssad_knn_tiled_occupancy",
                    [ctypes.c_int, ctypes.POINTER(ctypes.c_int)])
    blocks = ctypes.c_int(0)
    _cuda.check(fn(index, ctypes.byref(blocks)), "knn_tiled_resident_ctas")
    return blocks.value


def knn_tiled_group_depth() -> int:
    """Depth of D that csrc/knn_tiled.cu, as built, sums in a fresh
    tensor-core accumulator before each IEEE f32 add; for the records."""
    return _cuda.bind("knn_tiled", "ssad_knn_tiled_group_depth", [])()


def knn_cosine_scores(queries: torch.Tensor, bank, k: int = 3) -> torch.Tensor:
    """By bank size (≤ PALLAS_MAX_BANK_ROWS: f32; above: bf16x3), then by
    device: CUDA tensors → the kernel; CPU tensors → the plain version.
    ``bank`` is an (M, D) tensor or, above PALLAS_MAX_BANK_ROWS rows, its
    TiledBank (``prepare_bank``)."""
    tiled = bank.shape[0] > PALLAS_MAX_BANK_ROWS
    if isinstance(bank, TiledBank) and not tiled:
        raise ValueError(
            f"a TiledBank of {bank.shape[0]} rows: banks of at most "
            f"{PALLAS_MAX_BANK_ROWS} rows take the f32 function, which needs the raw bank"
        )
    if queries.device.type == "cuda":
        if tiled:
            return knn_cosine_scores_tiled_cuda(queries, bank, k=k)
        return knn_cosine_scores_cuda(queries, bank, k=k)
    if queries.device.type == "cpu" and bank.device.type == "cpu":
        if tiled:
            return knn_cosine_scores_tiled_plain(queries, bank, k=k)
        return knn_cosine_scores_plain(queries, bank, k=k)
    raise ValueError(
        f"queries on {queries.device} and bank on {bank.device}: "
        "k-NN scoring runs on one CUDA device or on the CPU"
    )
