"""ssad_tpu_torch — the PyTorch/CUDA port of ssad_tpu.

A second package beside the JAX one, with the same module names and
layout so each module's counterpart is easy to find.  It imports torch,
numpy and PIL, never JAX and nothing of ``ssad_tpu``: what it needs from
there it keeps as its own copy.

Every entry point runs on the CUDA device unless the caller asks for the
CPU (``device="cpu"`` / ``--device cpu``); with no card and no explicit
CPU request it raises (utils/device.py).  The kernels of the serving
paths are CUDA written for Hopper (csrc/knn.cu, csrc/knn_tiled.cu,
csrc/stem_pool.cu), built with nvcc at first use.

Package map (so far: the image- and patch-mode serving paths):
  config, constants  — dataclass configuration, MVTec taxonomy
  utils/             — device resolution, reference-checkpoint I/O,
                       the JAX-variables → state_dict bridge, dataset
                       listing
  ops/               — image normalization/resize/blur ⊗ upsample, window
                       extraction, the fused stem and k-NN scoring, each
                       with its kernel
  models/            — ResNet-18 (with the folded 32×32 stem), PeraNet,
                       AnomalyDetector
  train/             — the memory bank's ring view
  evaluation/        — InferenceEngine (image and patch paths) and the
                       normality source
  data/              — image decoding, the train-good split
  serving/           — export artifact, batching HTTP server, CLI
"""

__version__ = "0.1.0"

__all__ = ["config", "constants", "__version__"]
