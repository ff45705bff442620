"""Data-parallel inference: each batch split over N devices.

Counterpart of ssad_tpu/parallel/infer_parallel.py.  The JAX
``ShardedEngine`` shard_maps the engine's four batch programs over a
('data',) mesh: weights and bank replicated, no collectives, each shard
running the k-NN and stem kernels on its own rows.  Here the same split
runs in one process: the batch is zero-padded to a multiple of N (as
JAX's ``_pad_rows``), cut into N equal slices, and slice i runs through
an ``InferenceEngine`` on device i, under ``device_context`` (the ctypes
kernel launches use the calling thread's current device:
serving/replicas.py).  Each device holds one copy of the model (made
once) and of the bank or fitted detector it scores against (made once
per bank or detector); slices on one device share them.  Outputs come
back to the wrapped engine's device, in order, padding rows dropped.
The slices run one after another from the calling thread; on separate
cards their kernels still overlap, because launches are asynchronous.

``ShardedEngine`` duck-types ``evaluation.inference.InferenceEngine``
(the batch methods, ``score_maps``, ``model`` and ``device``), so
``predict_mvtec``, ``normality_embeddings`` and the evaluator's patch
loop run sharded when handed one.  Grad-CAM reads ``model`` and stays
on the wrapped engine's device.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional, Sequence

import torch

from ssad_tpu_torch.evaluation.inference import InferenceEngine
from ssad_tpu_torch.ops.knn import TiledBank
from ssad_tpu_torch.parallel.mesh import ShardingError, shard_devices
from ssad_tpu_torch.serving.replicas import device_context


def _pad_rows(x: torch.Tensor, multiple: int):
    """(x zero-padded to a multiple of ``multiple`` rows, its rows)."""
    n = x.shape[0]
    rem = n % multiple
    if rem == 0:
        return x, n
    return torch.cat([x, x.new_zeros((multiple - rem,) + tuple(x.shape[1:]))]), n


def _indexed(device) -> torch.device:
    """``cuda`` as ``cuda:<current>``, so one card has one name."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _to(value, device: torch.device):
    if isinstance(value, TiledBank):
        return TiledBank(value.hi.to(device), value.lo.to(device), value.dim)
    return value.to(device)


class ShardedEngine:
    """An ``InferenceEngine`` whose batches are split over ``devices``."""

    def __init__(self, engine: InferenceEngine, devices: Sequence):
        self.engine = engine
        self.devices = [_indexed(d) for d in devices]
        self.n_data = len(self.devices)
        self._home = _indexed(engine.device)
        self._engines = {self._home: engine}
        self._copies = {}  # (id of a bank or detector, device) → (it, its copy there)

    @property
    def model(self):
        return self.engine.model

    @property
    def device(self) -> torch.device:
        return self.engine.device

    def _engine_on(self, device: torch.device) -> InferenceEngine:
        if device not in self._engines:
            with device_context(device):
                self._engines[device] = InferenceEngine(copy.deepcopy(self.engine.model), device)
        return self._engines[device]

    def _copy_on(self, value, device: torch.device, make):
        """``make(value, device)`` once per (value, device); ``value`` itself
        on its own device."""
        key = (id(value), device)
        hit = self._copies.get(key)
        if hit is None or hit[0] is not value:
            hit = self._copies[key] = (value, make(value, device))
        return hit[1]

    def _run(self, x_normalized, fn):
        """``fn(engine, device, slice)`` for each device and its slice of the
        padded batch → (the outputs in device order, the real rows)."""
        x = torch.as_tensor(x_normalized, dtype=torch.float32)
        x, n = _pad_rows(x, self.n_data)
        outs = []
        for dev, part in zip(self.devices, x.chunk(self.n_data)):
            with device_context(dev):
                outs.append(fn(self._engine_on(dev), dev, part))
        return outs, n

    def _cat(self, parts):
        return torch.cat([p.to(self.device) for p in parts])

    # -- InferenceEngine's interface -------------------------------------------

    def predict_batch(self, x_normalized):
        outs, n = self._run(x_normalized, lambda e, dev, part: e.predict_batch(part))
        return self._cat([o[0] for o in outs])[:n], self._cat([o[1] for o in outs])[:n]

    def predict_patches(self, x_normalized, dim: int = 32, stride: int = 8):
        outs, n = self._run(x_normalized,
                            lambda e, dev, part: e.predict_patches(part, dim, stride))
        ppi = outs[0][2]
        return (self._cat([o[0] for o in outs])[: n * ppi],
                self._cat([o[1] for o in outs])[: n * ppi], ppi)

    def score_patch_maps(self, x_normalized, bank, dim: int = 32, stride: int = 8, k: int = 3,
                         upsample_to: Optional[int] = None) -> torch.Tensor:
        def one(e, dev, part):
            return e.score_patch_maps(part, self._copy_on(bank, dev, _to), dim, stride, k,
                                      upsample_to)

        outs, n = self._run(x_normalized, one)
        return self._cat(outs)[:n]

    def score_patch_maps_mahalanobis(self, x_normalized, mean, precision, dim: int = 32,
                                     stride: int = 8,
                                     upsample_to: Optional[int] = None) -> torch.Tensor:
        def one(e, dev, part):
            return e.score_patch_maps_mahalanobis(
                part, self._copy_on(mean, dev, _to), self._copy_on(precision, dev, _to), dim,
                stride, upsample_to)

        outs, n = self._run(x_normalized, one)
        return self._cat(outs)[:n]

    def score_maps(self, x_normalized, score, dim: int = 32, stride: int = 8,
                   upsample_to: Optional[int] = None) -> torch.Tensor:
        """``InferenceEngine.score_maps`` per slice.  ``score`` is a fitted
        detector's ``score``: each device scores with that detector's
        copy there (its arrays moved once)."""
        def one(e, dev, part):
            return e.score_maps(part, self._score_on(score, dev), dim, stride, upsample_to)

        outs, n = self._run(x_normalized, one)
        return self._cat(outs)[:n]

    def _score_on(self, score, device: torch.device):
        if device == self._home:
            return score
        det = getattr(score, "__self__", None)
        if det is None or not hasattr(det, "arrays"):
            raise ValueError("a sharded score_maps takes a fitted detector's score")

        def move(d, dev):
            return dataclasses.replace(d, **{k: v.to(dev) for k, v in d.arrays().items()})

        return self._copy_on(det, device, move).score


def maybe_shard_engine(engine: InferenceEngine, data_shards: Optional[int],
                       devices: Optional[Sequence] = None):
    """``engine`` itself when ``data_shards`` is None or 1, else a
    ``ShardedEngine`` over ``devices`` (default: the first
    ``data_shards`` devices of the engine's kind); more shards than
    devices raise ``ShardingError``.  The one decision point the CLI and
    the evaluator route through."""
    if not data_shards or data_shards == 1:
        return engine
    if devices is None:
        devices = shard_devices(data_shards, engine.device.type)
    elif data_shards > len(devices):
        raise ShardingError(f"data_shards={data_shards} exceeds {len(devices)} available devices")
    return ShardedEngine(engine, list(devices)[:data_shards])
