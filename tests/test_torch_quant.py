"""Serving weights in bfloat16 and int8 (serving/quant.py, the ``dtype``
of serving/export.py) against the JAX package's (ssad_tpu/serving/
quant.py, export.py:69-95), on one seeded reference-layout PeraNet
(f32 compute) and a 40-row bank, imsize 64, batch 4.

Held:
* int8: the port's q and scale of every tensor with two or more axes
  bit-equal to ``quantize_tree``'s after the layout transpose (the JAX
  output channel is the last axis, the port's the first); the same 26
  tensors quantized, 1-D ones untouched;
* the int8 artifact's scores within 5e-3 of the JAX int8 artifact's (the
  bf16 model tolerance on embeddings, tests/test_torch_models.py; measured
  6.0e-8: both dequantize to the same bf16 values) and its labels equal to
  the float32 artifact's, as the JAX package's own test pins them
  (tests/test_serving.py::test_int8_weight_only_quantization), its scores
  within that test's 0.03 of the float32 ones;
* the bfloat16 artifact's scores within 5e-3 of the JAX bfloat16
  artifact's (measured 2.0e-4: both store every floating tensor, the
  BatchNorm statistics too, as bf16, and the JAX BatchNorm then computes
  in bf16 where the port's computes in f32) and within 0.02 of the float32
  artifact's (the JAX test's
  limit); the sizes: bf16 < 0.7 × f32, int8 < 0.45 × f32, as the JAX
  tests hold theirs.
"""

import jax
import numpy as np
import pytest
import torch
from _torch_port import jax_variables, seeded
from test_ref_checkpoint import reference_state_dict

from ssad_tpu.evaluation.inference import InferenceEngine as JEngine
from ssad_tpu.serving import export as jexport
from ssad_tpu.serving.quant import quantize_tree
from ssad_tpu.utils.ref_checkpoint import convert_peranet_state_dict
from ssad_tpu_torch.config import ModelConfig
from ssad_tpu_torch.serving import quant
from ssad_tpu_torch.serving.export import ServedScorer, export_checkpoint, read_artifact
from ssad_tpu_torch.utils.ref_checkpoint import save_reference_checkpoint

torch.set_num_threads(1)
IMSIZE, BATCH = 64, 4
TOL = 5e-3


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """{dtype: (path, ServedScorer)} of one checkpoint, and its state dict."""
    root = tmp_path_factory.mktemp("quant")
    sd = reference_state_dict(seed=0)
    bank = np.random.default_rng(1).standard_normal((40, 512)).astype(np.float32)
    ckpt = root / "bottle" / "best_model.ckpt"
    save_reference_checkpoint(ckpt, sd, bank, ModelConfig(compute_dtype="float32"))
    out = {}
    for dtype in ("float32", "bfloat16", "int8"):
        path = export_checkpoint(ckpt, root / f"{dtype}.ssadpt", batch=BATCH,
                                 imsize=(IMSIZE, IMSIZE), subject="bottle", device="cpu",
                                 dtype=None if dtype == "float32" else dtype)
        out[dtype] = (path, ServedScorer.from_file(path, device="cpu"))
    return out, sd


def _jax_tree(treedef, leaves):
    return jax.tree_util.tree_unflatten(treedef, list(leaves))


def test_q_and_scale_bit_equal_to_jax():
    sd = reference_state_dict(seed=0)
    _, params, stats = jax_variables(sd, "float32")
    qt = quantize_tree({"params": params, "batch_stats": stats})
    q, scales = quant.quantize_state_dict(sd)
    assert len(scales) == sum(1 for leaf in qt.leaves if leaf.dtype == np.int8) == 26
    assert all(q[k].dtype == torch.int8 and q[k].ndim >= 2 for k in scales)
    assert all(torch.equal(q[k], sd[k]) for k in sd if k not in scales)
    # the port's q and its scales broadcast to each weight's shape, through
    # the JAX package's layout converter: every leaf lands where the JAX
    # package keeps its own
    q_tree, _ = convert_peranet_state_dict(
        {k: v.float().numpy() if k in scales else v.numpy() for k, v in q.items()})
    s_tree, _ = convert_peranet_state_dict(
        {k: (scales[k].view((-1,) + (1,) * (v.ndim - 1)) * torch.ones_like(v)).numpy()
         if k in scales else v.numpy() for k, v in sd.items()})
    jq = _jax_tree(qt.treedef, qt.leaves)["params"]
    js = _jax_tree(qt.treedef, [np.zeros(()) if s is None else s for s in qt.scales])["params"]
    checked = 0
    for (path, want_q), got_q, want_s, got_s in zip(
            jax.tree_util.tree_leaves_with_path(jq), jax.tree_util.tree_leaves(q_tree),
            jax.tree_util.tree_leaves(js), jax.tree_util.tree_leaves(s_tree)):
        if np.asarray(want_q).dtype != np.int8:
            continue
        want_q = np.asarray(want_q)
        assert np.array_equal(np.asarray(got_q), want_q.astype(np.float32)), path
        assert np.array_equal(np.asarray(got_s, np.float32),
                              np.broadcast_to(np.asarray(want_s), want_q.shape)), path
        checked += 1
    assert checked == 26


def test_dequantize_is_the_jax_arithmetic():
    w = torch.from_numpy(np.random.default_rng(3).normal(0, 0.1, (32, 16, 3, 3)).astype(np.float32))
    q, s = quant.quantize(w)
    d = quant.dequantize(q, s)
    assert d.dtype == torch.bfloat16
    want = (q.float() * s.view(-1, 1, 1, 1)).to(torch.bfloat16)
    assert torch.equal(d, want)
    amax = w.abs().amax(dim=(1, 2, 3))
    err = (w - d.float()).abs().amax(dim=(1, 2, 3))
    assert bool((err <= amax / 254 + amax * 2**-8 + 1e-8).all())


def test_artifact_layout_and_sizes(artifacts):
    import os

    arts, sd = artifacts
    sizes = {k: os.path.getsize(p) for k, (p, _) in arts.items()}
    assert sizes["bfloat16"] < 0.7 * sizes["float32"] and sizes["int8"] < 0.45 * sizes["float32"]
    meta, payload = read_artifact(arts["int8"][0])
    assert meta["weights_dtype"] == "int8" and payload["bank"].dtype == torch.float32
    assert len(payload["scales"]) == 26
    assert {k for k, v in payload["state_dict"].items() if v.dtype == torch.int8} == \
        set(payload["scales"])
    meta16, payload16 = read_artifact(arts["bfloat16"][0])
    assert meta16["weights_dtype"] == "bfloat16" and "scales" not in payload16
    assert all(v.dtype == torch.bfloat16 for v in payload16["state_dict"].values()
               if v.is_floating_point())


@pytest.mark.parametrize("dtype,f32_tol", [("int8", 0.03), ("bfloat16", 0.02)])
def test_scores_match_the_jax_artifact(artifacts, tmp_path, dtype, f32_tol):
    arts, sd = artifacts
    path, scorer = arts[dtype]
    meta, payload = read_artifact(path)
    model, params, stats = jax_variables(sd, "float32")
    exported, jmeta = jexport.export_scorer(
        JEngine(model, params, stats), payload["bank"].numpy(), mode="image", batch=BATCH,
        imsize=(IMSIZE, IMSIZE), k=3, threshold=meta["threshold"], platform="cpu", dtype=dtype)
    assert jmeta["weights_dtype"] == meta["weights_dtype"] == dtype
    jscorer = jexport.load_scorer(jexport.save_artifact(tmp_path / "j.ssadexp", exported, jmeta))
    imgs = seeded((6, IMSIZE, IMSIZE, 3), 9)
    scores, labels, _ = scorer(imgs)
    jscores, _, _ = jscorer(imgs)
    err = float(np.abs(scores - jscores).max())
    print(f"{dtype}: port vs JAX {err:.3g}")
    assert err <= TOL
    s32, l32, _ = arts["float32"][1](imgs)
    np.testing.assert_allclose(scores, s32, atol=f32_tol, rtol=0)
    if dtype == "int8":
        np.testing.assert_array_equal(labels, l32)
