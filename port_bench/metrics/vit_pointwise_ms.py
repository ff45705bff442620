"""The transformer trunk's pointwise passes (models/vit.py): device ms per
image batch of the kernels whose names say they are such a pass:
csrc/vit_pointwise.cu's ``residual_ln_kernel`` and ``silu_mul_kernel``
where the program has them, and PyTorch's elementwise and LayerNorm
kernels (``at::native``'s ``*elementwise_kernel*`` and ``*layer_norm*``):
the LayerNorms, LayerScale's products, the residual sums, SiLU and its
product, and the casts, the weights' included.  A kernel of any other name
(a product, the attention, the k-NN, a copy, a kernel a later version
adds) is not counted.  Per batch = per ``knn_cluster_kernel`` call
(``readers.batches_in_trace``).
"""

from port_bench.core import readers
from port_bench.reference.vit import ARCHS

#: parts of the names of the kernels that are counted
COUNTED = ("residual_ln_kernel", "silu_mul_kernel", "elementwise_kernel", "layer_norm")


def read(ctx):
    trace = ctx.get("trace")
    if ctx.get("mode") != "image" or trace is None or ctx["config"]["backbone"] not in ARCHS:
        return None
    n = readers.batches_in_trace(ctx)
    if not n:
        return None
    passes = sum(e - s for name, s, e in trace.device if any(tag in name for tag in COUNTED))
    return passes / 1e3 / n
