"""The benchmark of ssad_tpu_torch, the PyTorch/CUDA port, on NVIDIA cards.

``run.py`` runs one cell of the root ``BENCHMARK.json`` and prints one JSON
line.  Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by name (README.md).
Nothing here imports JAX or the JAX package; ``reference/`` imports
nothing of the port either.
"""
