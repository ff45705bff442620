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

Package map (every module of the JAX package has its counterpart: the
image- and patch-mode serving paths with their extras, device replicas
and the native front end, the pretext synthesizer, two-phase training,
evaluation with its figures and localization, the other scorers and
backbones, the harness, multi-device training and evaluation):
  config, constants  — dataclass configuration (TrainConfig and its JSON
                       form), MVTec taxonomy
  cli                — train, sweep, train-multi, import-ckpt, evaluate,
                       infer, localize, qa, parity, profile, doctor; the
                       serving commands of serving/cli.py
  utils/             — device resolution, reference-checkpoint I/O, the
                       JAX-state bridge, torchvision backbone weights,
                       dataset listing, label conversions
  ops/               — image ops, window extraction, rasterisers, the fused
                       stem and k-NN scoring, each with its kernel, the
                       k-center coreset
  models/            — ResNet-18/34/50 and Wide-ResNet-50-2 (the folded
                       32×32 stem, Flax-order BatchNorm), PeraNet and its
                       init, the k-NN and Mahalanobis detectors, Grad-CAM
  train/             — the memory bank, the stage optimizer, the trainer,
                       checkpoints, the train step's cross-device check
  evaluation/        — InferenceEngine (image and patch paths), metrics on
                       the host and the card, the evaluator and its tables,
                       the localizer, t-SNE, figures
  data/              — image decoding, the train-good split, the test set,
                       object masks, the CutPaste synthesizer
  serving/           — export artifacts (float32, bfloat16, int8 weights),
                       batching HTTP server (/metrics, /admin/reload),
                       device replicas (``serve --devices``), the native
                       front end's binding, client, load generator, score
                       drift, CLI
  native/            — host C++ built with g++ at first use: the epoll
                       HTTP transport of ``serve --frontend native``
  parallel/          — torch.distributed: the (model, data) rank grid,
                       process groups and launching, data-parallel
                       training's ranks, categories in lockstep
                       (``train-multi``), batch-sharded inference
"""

__version__ = "0.1.0"

__all__ = ["config", "constants", "__version__"]
