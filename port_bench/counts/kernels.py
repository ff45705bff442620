"""Operations and bytes of the port's hand-written kernels' functions, and
the least time the card could take for them.

* Stem (``csrc/stem_pool.cu``): nearest-×2 upsampling + the 7×7/s2 conv on
  a 32×32 window is one 4×4/s1 conv, 48 products per output (the least
  work for that function), for 32·32·64 outputs a window; the windows read
  once (bf16), the folded weights and affine read once, the pooled
  (16, 16, 64) bf16 maps written once.  As chip_smoke.stem_bound counts it.
* k-NN (``csrc/knn.cu``, ``csrc/knn_tiled.cu``): the similarity of N
  queries to M bank rows of depth D is 2·N·M·D operations, held against
  the dense bf16 peak, the highest rate any implementation could use;
  queries and bank read once as float32, the N scores written once.
"""

from __future__ import annotations

from typing import Tuple

from port_bench.counts import PEAKS


def bound_s(ops: float, nbytes: float) -> Tuple[float, str]:
    """(seconds, 'operations' | 'bytes'): the larger of operations over the
    bf16 peak and bytes over the memory rate."""
    t_ops = ops / PEAKS["bf16_flop_per_s"]
    t_bytes = nbytes / PEAKS["hbm_bytes_per_s"]
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def stem(n: int, features: int = 64) -> Tuple[float, float]:
    """(operations, bytes) of the folded stem + BN + ReLU + max-pool over n
    32×32×3 windows."""
    ops = 2 * n * 32 * 32 * features * 48
    nbytes = 2 * n * 32 * 32 * 3 + 2 * 48 * features + 4 * 2 * features \
        + 2 * n * 16 * 16 * features
    return float(ops), float(nbytes)


def knn(n: int, m: int, d: int) -> Tuple[float, float]:
    """(operations, bytes) of the k-NN cosine scores of n queries against m
    bank rows of depth d."""
    return float(2 * n * m * d), float(4 * (n * d + m * d + n))
