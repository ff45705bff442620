"""One device replica on ``cuda:0`` behind the native front end, against
direct ``ServedScorer`` calls on the card.  Every test here takes the
``cuda_device`` fixture and skips where there is no card.

This file imports neither JAX nor the JAX package, so it also runs on a
machine without them:  python -m pytest --noconftest tests/test_torch_native_cuda.py
Limit: the HTTP scores equal the direct scorer's within 1e-6 and the
labels exactly (the same f32 program on the same card, TF32 off; the
batcher pads each request's batch as the direct call does), through
``serve``'s loader at ``--devices 0`` (all cards: a replica each).
"""

import threading

import numpy as np
import pytest
import torch
from _torch_port import cuda_device  # noqa: F401  (fixture)

from ssad_tpu_torch.config import ModelConfig
from ssad_tpu_torch.models.peranet import build_model, init_model


@pytest.fixture()
def no_tf32():
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def test_native_server_on_a_cuda_replica_matches_the_direct_scorer(cuda_device, no_tf32,
                                                                   tmp_path):
    from ssad_tpu_torch.serving import native_frontend
    from ssad_tpu_torch.serving.cli import _load_artifact_models, _make_http_server
    from ssad_tpu_torch.serving.client import ServingClient
    from ssad_tpu_torch.serving.export import ServedScorer, export_checkpoint
    from ssad_tpu_torch.serving.replicas import DeviceReplica
    from ssad_tpu_torch.utils.ref_checkpoint import save_reference_checkpoint

    if not native_frontend.available():
        pytest.skip("native HTTP front end not buildable here (g++)")
    sd = init_model(build_model(ModelConfig(compute_dtype="float32")),
                    torch.Generator().manual_seed(2)).state_dict()
    bank = np.random.default_rng(2).standard_normal((40, 512)).astype(np.float32)
    ckpt = tmp_path / "bottle" / "best_model.ckpt"
    save_reference_checkpoint(ckpt, sd, bank, ModelConfig(compute_dtype="float32"))
    art = export_checkpoint(ckpt, tmp_path / "a.ssadpt", batch=4, imsize=(64, 64),
                            subject="bottle", device=cuda_device)
    models, _ = _load_artifact_models([art], 5.0, 256, cuda_device, devices=0)
    batcher, _ = models["bottle"]
    reps = batcher._fns
    assert len(reps) == torch.cuda.device_count()
    assert all(isinstance(r, DeviceReplica) and r.device.type == "cuda" for r in reps)
    server, frontend = _make_http_server("native", host="127.0.0.1", port=0, models=models)
    assert frontend == "native"
    server.start()
    imgs = np.random.default_rng(3).uniform(size=(12, 64, 64, 3)).astype(np.float32)
    got = {}

    def worker(i):
        with ServingClient(f"http://127.0.0.1:{server.port}") as c:
            got[i] = c.score(imgs[i])

    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        ts = server.transport_stats()
    finally:
        server.stop()
    assert len(got) == 12 and ts["shed_transport"] == 0 and ts["protocol_errors"] == 0
    direct, labels, _ = ServedScorer.from_file(art, device=cuda_device)(imgs)
    http = np.array([got[i]["score"] for i in range(12)], np.float32)
    assert float(np.abs(http - direct).max()) <= 1e-6
    assert [got[i]["label"] for i in range(12)] == labels.tolist()
