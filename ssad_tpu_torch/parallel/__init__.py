"""Multi-device training and evaluation on ``torch.distributed``.

Counterpart of ssad_tpu/parallel/: the (model, data) rank grid
(``mesh``), the multi-process layer (``distributed``), the stacked
category trainer behind ``train-multi`` (``category_parallel``) and
batch-sharded inference (``infer_parallel``).
"""

from ssad_tpu_torch.parallel import mesh

__all__ = ["mesh"]
