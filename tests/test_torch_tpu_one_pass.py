"""The TPU's own roundings of the JAX program, emulated in both packages.

A TPU runs an f32 dot at DEFAULT precision as one bf16 pass: both
operands rounded to bf16, the products summed in f32.
scripts/tpu_precision_census.py lists where the JAX program has such
dots: the head's dense layers (ssad_tpu/models/peranet.py:107-115), the
memory-bank insert (ssad_tpu/train/memory_bank.py:65) and the
synthesizer's line dots.  The port computes them in f32, as the source
declares, and as the JAX package computes them on the CPU.

``_torch_train.tpu_one_pass`` re-evaluates a JAX program with every such
dot rounded.  ``scripts/torch_parity_replay.py``'s ``tpu_one_pass``
patches give the port the same roundings on the card: the dense layers
through ``_OnePassLinear`` (forward and backward), the bank's rows in
bf16.  These tests hold the second to the first on the CPU, so that the
card's ``--variants one_pass`` runs are the JAX program as a TPU rounds
it:

* a dense layer alone, at the head's widths: the output and both
  gradients agree within ``DENSE_RTOL`` of their largest value (measured
  0 to 6.0e-7: f32 summation order), while the roundings move them by at
  least ``ONE_PASS_EFFECT`` (measured 1.6e-3 to 4.3e-3);
* the bank's rows: equal bit for bit;
* the whole head in eval mode: the two emulations part only where a
  value's bf16 rounding flips between the packages' f32 sums, so they
  agree within ``HEAD_RATIO`` of the roundings' own effect in L2
  (measured 0.06 and 0.09; the effect is 5.0e-3 of the embedding and
  5.3e-3 of the logits, in L2 relative).

Without the patches the port misses each check (planted).
"""

import contextlib
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_train import tpu_one_pass

from ssad_tpu.config import ModelConfig as JModelConfig
from ssad_tpu.models.peranet import PeraNet
from ssad_tpu.models.peranet import build_model as jbuild_model
from ssad_tpu.models.peranet import init_model
from ssad_tpu.train import memory_bank as jbank
from ssad_tpu_torch.config import ModelConfig
from ssad_tpu_torch.models.peranet import build_model
from ssad_tpu_torch.train import memory_bank as pbank
from ssad_tpu_torch.train import trainer as ptrainer
from ssad_tpu_torch.utils.jax_bridge import state_dict_from_jax

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
import torch_parity_replay as replay  # noqa: E402

torch.set_num_threads(1)
DENSE_RTOL = 5e-6
ONE_PASS_EFFECT = 1e-3
HEAD_RATIO = 0.15


def _port_one_pass(on: bool):
    return replay.patched(*replay.tpu_one_pass()) if on else contextlib.nullcontext()


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("n_in,n_out,bias", [(896, 512, False), (512, 512, True),
                                             (512, 4, True)])
def test_dense_one_pass_equals_jax(n_in, n_out, bias):
    rng = np.random.default_rng(n_in + n_out)
    x = rng.normal(size=(64, n_in)).astype(np.float32)
    w = (rng.normal(size=(n_out, n_in)) / np.sqrt(n_in)).astype(np.float32)
    b = rng.normal(size=(n_out,)).astype(np.float32) if bias else np.zeros(n_out, np.float32)
    g = rng.normal(size=(64, n_out)).astype(np.float32)

    @jax.jit
    def dense(x, w, b, g):
        y, vjp = jax.vjp(lambda x, w, b: x @ w.T + b, x, w, b)
        return (y, *vjp(g))

    want = [np.asarray(a) for a in tpu_one_pass(dense)(x, w, b, g)]
    plain = [np.asarray(a) for a in dense(x, w, b, g)]

    def port(on):
        lin = torch.nn.Linear(n_in, n_out, bias=bias)
        with torch.no_grad():
            lin.weight.copy_(torch.from_numpy(w))
            if bias:
                lin.bias.copy_(torch.from_numpy(b))
        xt = torch.from_numpy(x).requires_grad_(True)
        with _port_one_pass(on):
            y = lin(xt)
        y.backward(torch.from_numpy(g))
        gb = lin.bias.grad.numpy() if bias else g.sum(0)
        return [y.detach().numpy(), xt.grad.numpy(), lin.weight.grad.numpy(), gb]

    names = ("output", "input grad", "weight grad", "bias grad")
    got, got_plain = port(True), port(False)
    for name, p, pp, j, jp in zip(names, got, got_plain, want, plain):
        assert _rel(p, j) <= DENSE_RTOL, f"{name}: {_rel(p, j):.2e}"
        if name != "bias grad":  # the bias's gradient is a sum, never rounded
            assert _rel(j, jp) >= ONE_PASS_EFFECT, f"{name}: the roundings moved nothing"
            assert _rel(pp, j) > DENSE_RTOL, f"{name}: the plain port matches (planted)"


def test_bank_rows_one_pass_equal_jax():
    rng = np.random.default_rng(3)
    emb = rng.normal(size=(12, 512)).astype(np.float32)
    mask = rng.random(12) < 0.6
    jb = jbank.insert(jbank.init_bank(16, 512), jnp.asarray(emb), jnp.asarray(mask))
    jb1 = tpu_one_pass(jax.jit(jbank.insert))(jbank.init_bank(16, 512), jnp.asarray(emb),
                                              jnp.asarray(mask))

    def port(on):
        with _port_one_pass(on):
            return ptrainer.insert(pbank.init_bank(16, 512), torch.from_numpy(emb),
                                   torch.from_numpy(mask)).data.numpy()

    assert np.array_equal(port(True), np.asarray(jb1.data))
    assert not np.array_equal(np.asarray(jb1.data), np.asarray(jb.data))
    assert not np.array_equal(port(False), np.asarray(jb1.data))  # planted


def test_head_one_pass_agrees_with_jax():
    jm = jbuild_model(JModelConfig())
    params, stats = jax.jit(lambda k: init_model(jm, k, (1, 64, 64, 3)))(jax.random.key(0))
    model = build_model(ModelConfig())
    model.load_state_dict(state_dict_from_jax(*jax.tree.map(np.asarray, (params, stats))),
                          strict=True)
    model.eval()
    rng = np.random.default_rng(0)
    shapes = {"layer2": (8, 8, 128), "layer3": (4, 4, 256)}
    feats = {t: np.maximum(rng.normal(size=(64, *shapes[t])), 0).astype(np.float32)
             for t in JModelConfig().layer_outputs}
    pooled = np.maximum(rng.normal(size=(64, 512)), 0).astype(np.float32)
    head = jax.jit(lambda p, s, f, q: jm.apply({"params": p, "batch_stats": s}, f, q,
                                              train=False, method=PeraNet.head))
    plain, want = head(params, stats, feats, pooled), tpu_one_pass(head)(params, stats, feats,
                                                                         pooled)

    def port(on):
        with torch.no_grad(), _port_one_pass(on):
            return model.head({t: torch.from_numpy(v).permute(0, 3, 1, 2)
                               for t, v in feats.items()}, torch.from_numpy(pooled))

    got, got_plain = port(True), port(False)
    for k in ("latent_space", "classifier"):
        ref = np.asarray(plain[k])
        effect = np.linalg.norm(np.asarray(want[k]) - ref)
        agree = np.linalg.norm(got[k].numpy() - np.asarray(want[k]))
        assert effect / np.linalg.norm(ref) >= ONE_PASS_EFFECT
        assert agree <= HEAD_RATIO * effect, f"{k}: {agree / effect:.3f} of the effect"
        assert np.linalg.norm(got_plain[k].numpy() - np.asarray(want[k])) > HEAD_RATIO * effect
