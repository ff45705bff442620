"""The pretext synthesizer on the card against the CPU, from the same
draws, for every regime at full width (256² images, 64² patches), and one
batch with no host sync.  Every test takes the ``cuda_device`` fixture and
skips where there is no card.

This file imports neither JAX nor the JAX package, so it runs on a
machine without them:
    python -m pytest --noconftest tests/test_torch_synth_cuda.py
Tolerance: none; labels and images equal bit for bit, as every run on
the H100 has read them.
"""

import numpy as np
import pytest
import torch
from _torch_port import cuda_device  # noqa: F401  (fixture)

from ssad_tpu_torch.data import masks
from ssad_tpu_torch.data import synthetic as syn
from ssad_tpu_torch.ops import image as im

SIZE, BATCH = 256, 32
REGIMES = [("bottle", False), ("hazelnut", False), ("carpet", False), ("carpet", True),
           ("screw", True)]


def _inputs(spec, n, seed=0):
    """(images, cut pool, masks, coords, counts) as CPU tensors: a noisy
    gradient with a bright disc; per-image masks for a non-fixed subject
    (1-row placeholder coordinates in patch mode)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:SIZE, 0:SIZE]
    base = np.stack([0.3 + 0.3 * xx / SIZE, 0.4 + 0.2 * yy / SIZE, 0.5 + 0 * xx], -1)
    imgs = np.clip(base[None] + rng.normal(0, 0.05, (n, SIZE, SIZE, 3)), 0, 1)
    mks, cs, ns = [], [], []
    for i in range(n):
        disc = (yy - 128 - i % 7) ** 2 + (xx - 128 + i % 5) ** 2 < 80**2
        imgs[i][disc] = np.clip(imgs[i][disc] + 0.25, 0, 1)
        m = disc.astype(np.uint8)
        c, k = (np.zeros((1, 2), np.int32), 0) if spec.patch_localization else masks.pack_coords(m)
        mks.append(m.astype(np.float32))
        cs.append(c)
        ns.append(k)
    imgs = imgs.astype(np.float32)
    pool = np.stack([imgs[0], np.roll(imgs[1], 40, axis=0)])
    if spec.is_non_fixed:
        m, c, k = np.stack(mks), np.stack(cs), np.asarray(ns, np.int32)
    else:
        c0, k0 = masks.pack_coords(mks[0].astype(np.uint8))
        m, c, k = mks[0], c0, np.int32(k0)
    return tuple(torch.from_numpy(np.asarray(a)) for a in (imgs, pool, m, c, k))


def _spec(subject, patch):
    return syn.SynthSpec(subject=subject, imsize=(SIZE, SIZE), patch_localization=patch)


@pytest.mark.parametrize("subject, patch", REGIMES)
def test_card_matches_the_cpu_from_the_same_draws(cuda_device, subject, patch):
    spec = _spec(subject, patch)
    inputs = _inputs(spec, BATCH)
    draws = syn.draw(spec, BATCH, torch.Generator().manual_seed(1), n_cut=2)
    x_cpu, y_cpu, _ = syn.synthesize(spec, draws, *inputs)
    x_gpu, y_gpu, _ = syn.synthesize(spec, draws.to(cuda_device),
                                     *(t.to(cuda_device) for t in inputs))
    assert torch.equal(y_cpu, y_gpu.cpu())
    diff = (im.denormalize_imagenet(x_gpu).cpu() - im.denormalize_imagenet(x_cpu)).abs()
    assert torch.equal(x_gpu.cpu(), x_cpu), float(diff.max())


@pytest.mark.parametrize("subject, patch", REGIMES)
def test_a_batch_runs_without_host_sync(cuda_device, subject, patch):
    spec = _spec(subject, patch)
    inputs = [t.to(cuda_device) for t in _inputs(spec, BATCH)]
    draws = syn.draw(spec, BATCH, torch.Generator().manual_seed(2), n_cut=2).to(cuda_device)
    syn.synthesize(spec, draws, *inputs)  # first call: the device constants are made
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        x, y, _ = syn.synthesize(spec, draws, *inputs)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    side = spec.canvas[0]
    assert x.shape == (BATCH, side, side, 3) and bool(torch.isfinite(x).all())
