"""ssad_tpu_torch — the PyTorch/CUDA port of ssad_tpu.

A second package beside the JAX one, with the same module names and
layout so each module's counterpart is easy to find.  It imports torch,
numpy and PIL, never JAX and nothing of ``ssad_tpu``: what it needs from
there it keeps as its own copy.

Every entry point runs on the CUDA device unless the caller asks for the
CPU (``device="cpu"`` / ``--device cpu``); with no card and no explicit
CPU request it raises (utils/device.py).  The k-NN scorer is a CUDA
kernel written for Hopper (csrc/knn.cu), built with nvcc at first use.

Package map (this slice: the image-mode serving path):
  config, constants  — dataclass configuration, MVTec taxonomy
  utils/             — device resolution, reference-checkpoint I/O,
                       the JAX-variables → state_dict bridge
  ops/               — image normalization/resize, k-NN scoring + kernel
  models/            — ResNet-18, PeraNet, AnomalyDetector
  train/             — the memory bank's ring view
  evaluation/        — InferenceEngine and the normality source
  data/              — image decoding
  serving/           — export artifact, batching HTTP server, CLI
"""

__version__ = "0.1.0"

__all__ = ["config", "constants", "__version__"]
