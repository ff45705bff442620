"""The batcher's staging buffer (serving/server.py ``BatchingScorer``) on
the card.  Every test takes the ``cuda_device`` fixture, carries the
``card`` marker and skips where there is no card.

Held, in image mode (ResNet-18 PeraNet, 256², batch 8) and patch mode
(64², batch 2), bf16 as served:
* a card scorer's buffer is page-locked, and made at warm-up;
* a ``ServedScorer``'s outputs through the batcher, for a full batch and
  then a short one, are bit-equal to ``scorer(np.stack(rows))`` on the
  same rows, which pads inside the scorer from a pageable array;
* a CPU scorer on the same host gets plain memory.

This file imports neither JAX nor the JAX package:
    python -m pytest --noconftest tests/test_torch_batcher_staging_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch
from _torch_port import cuda_device, seeded_state_dict  # noqa: F401  (fixture)

from ssad_tpu_torch.config import ModelConfig
from ssad_tpu_torch.models.peranet import build_model
from ssad_tpu_torch.serving.export import ServedScorer
from ssad_tpu_torch.serving.server import BatchingScorer

GEOMETRY = {"image": dict(imsize=256, batch=8), "patch": dict(imsize=64, batch=2)}
#: long enough that rows submitted together always make one batch
DELAY_MS = 300.0

pytestmark = pytest.mark.card


def _scorer(mode: str, device) -> ServedScorer:
    cfg = ModelConfig()
    size, batch = GEOMETRY[mode]["imsize"], GEOMETRY[mode]["batch"]
    meta = {"mode": mode, "batch": batch, "imsize": [size, size], "k": 3, "threshold": 0.5,
            "patch_dim": 32, "stride": 8, "upsample_to": size if mode == "patch" else None,
            "scorer": "knn", "model": dataclasses.asdict(cfg), "weights_dtype": "float32"}
    state = seeded_state_dict(build_model(cfg), 0)
    bank = torch.randn(300, cfg.latent_dim, generator=torch.Generator().manual_seed(1))
    return ServedScorer(meta, state, device, bank=bank)


@pytest.mark.parametrize("mode", ["image", "patch"])
def test_served_outputs_through_the_pinned_buffer_equal_the_plain_stack(cuda_device, mode):
    scorer = _scorer(mode, cuda_device)
    batch, size = scorer.batch, GEOMETRY[mode]["imsize"]
    rows = list(np.random.default_rng(2).uniform(0, 1, (batch + batch // 2, size, size, 3))
                .astype(np.float32))
    sc = BatchingScorer(scorer, batch=batch, max_delay_ms=DELAY_MS,
                        warmup=lambda fn: fn.warmup())
    try:
        buf = sc._staging[0].buf
        groups = [rows[:batch], rows[batch:]]
        answers = []
        for group in groups:
            reqs = [sc.submit(r) for r in group]
            assert all(r.event.wait(120) for r in reqs)
            assert all(r.error is None for r in reqs)
            answers.append(reqs)
        assert sc._staging[0].buf is buf
    finally:
        sc.close()
    assert torch.from_numpy(buf).is_pinned()
    assert buf.shape == (batch, size, size, 3) and buf.dtype == np.float32
    for group, reqs in zip(groups, answers):
        want = scorer(np.stack(group))
        for i, r in enumerate(reqs):
            assert len(r.result) == len(want)
            for got, ref in zip(r.result, want):
                assert got.dtype == ref.dtype and got.shape == ref[i:i + 1].shape
                assert got.tobytes() == ref[i:i + 1].tobytes()


def test_a_cpu_scorer_beside_the_card_gets_plain_memory(cuda_device):
    scorer = _scorer("patch", torch.device("cpu"))
    size = GEOMETRY["patch"]["imsize"]
    rows = list(np.random.default_rng(3).uniform(0, 1, (scorer.batch, size, size, 3))
                .astype(np.float32))
    sc = BatchingScorer(scorer, batch=scorer.batch, max_delay_ms=DELAY_MS,
                        warmup=lambda fn: fn.warmup())
    try:
        reqs = [sc.submit(r) for r in rows]
        assert all(r.event.wait(120) for r in reqs)
        assert all(r.error is None for r in reqs)
        buf = sc._staging[0].buf
    finally:
        sc.close()
    assert not torch.from_numpy(buf).is_pinned()
    want = scorer(np.stack(rows))
    for i, r in enumerate(reqs):
        assert r.result[0].tobytes() == want[0][i:i + 1].tobytes()
