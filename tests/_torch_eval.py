"""Shared parts of the evaluation slice's parity tests
(tests/test_torch_eval*.py, test_torch_evaluator.py, test_torch_gradcam.py):
one seeded f32 PeraNet written as a checkpoint of each package, the JAX
package's fit permutation and its artificial-batch draws handed to the
port, and the JAX engine on the same weights."""

import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch
from _torch_port import jax_variables
from _torch_synth import jax_draws

from ssad_tpu.config import DataConfig as JDataConfig
from ssad_tpu.config import ModelConfig as JModelConfig
from ssad_tpu.config import TrainConfig as JTrainConfig
from ssad_tpu.evaluation import inference as jinf
from ssad_tpu.train import checkpoint as jckpt
from ssad_tpu_torch.config import DataConfig, ModelConfig, TrainConfig
from ssad_tpu_torch.data.synthetic import SynthDraws
from ssad_tpu_torch.evaluation import inference as inf
from ssad_tpu_torch.models.peranet import build_model, init_model
from ssad_tpu_torch.train.checkpoint import save_checkpoint

torch.set_num_threads(1)

IMSIZE = 64
#: the f32 model's tolerance against JAX (tests/test_torch_models.py)
MODEL_TOL = 1e-5


def seeded_state_dict(seed: int = 0) -> dict:
    """An f32 PeraNet from the JAX package's init distribution."""
    model = build_model(ModelConfig(compute_dtype="float32"))
    return init_model(model, torch.Generator().manual_seed(seed)).state_dict()


def write_checkpoints(root, subjects, state_dict, imsize: int = IMSIZE):
    """The same weights as ``<root>/port/<s>/best_model.ckpt`` and the JAX
    package's ``<root>/jax/<s>/best_model`` (f32 compute, no bank) →
    (port models dir, JAX models dir)."""
    _, params, stats = jax_variables(state_dict, "float32")
    for s in subjects:
        save_checkpoint(root / "port" / s, state_dict, None, TrainConfig(
            data=DataConfig(subject=s, imsize=(imsize, imsize)),
            model=ModelConfig(compute_dtype="float32")))
        jckpt.save_checkpoint(root / "jax" / s, params, stats, None, JTrainConfig(
            data=JDataConfig(subject=s, imsize=(imsize, imsize)),
            model=JModelConfig(compute_dtype="float32")))
    return root / "port", root / "jax"


def jax_engine(state_dict):
    model, params, stats = jax_variables(state_dict, "float32")
    return jinf.InferenceEngine(model, params, stats)


def jax_perm(seed: int, m: int) -> torch.Tensor:
    """The JAX detector's 70/30 permutation (``AnomalyDetector.fit``)."""
    return torch.from_numpy(np.array(jax.random.permutation(jax.random.key(seed), m)))


def jax_coreset_first(seed: int, n_train: int) -> int:
    """The first center the JAX detector's coreset draws from its train
    split (``AnomalyDetector.fit`` → ``kcenter_greedy``)."""
    key = jax.random.fold_in(jax.random.key(seed), 1)
    return int(jax.random.randint(key, (), 0, n_train))


def jax_artificial_batches(spec, n_images, n_cut, num_samples, batch_size, seed):
    """The JAX ``predict_artificial``'s image indices and draws per batch,
    in the port's form (``inference.artificial_batches``'s signature); the
    draws of every batch are read from the key tree in one call."""
    rng, idxs, keys = jax.random.key(seed), [], []
    for _ in range(0, num_samples, batch_size):
        rng, k_idx, k_syn = jax.random.split(rng, 3)
        idxs.append(np.array(jax.random.randint(k_idx, (batch_size,), 0, n_images)))
        keys.append(jax.random.split(k_syn, batch_size))
    every = jax_draws(spec, jnp.concatenate(keys), n_cut)
    names = [f.name for f in dataclasses.fields(SynthDraws)
             if f.name not in ("label_order", "label_counts")]
    for b, idx in enumerate(idxs):
        rows = slice(b * batch_size, (b + 1) * batch_size)
        yield (torch.from_numpy(idx).long(),
               SynthDraws(**{n: getattr(every, n)[rows] for n in names}))


def with_jax_draws(monkeypatch):
    """Make the port's evaluation draw as the JAX package does: the fit
    permutation (both detectors), the coreset's first center and the
    artificial batches."""
    from ssad_tpu_torch.models import detector

    fit, maha_fit = detector.AnomalyDetector.fit, detector.MahalanobisDetector.fit

    def fit_with_jax_perm(self, embeddings, generator=None, perm=None, coreset=None):
        if perm is None:
            perm = jax_perm(int(generator.initial_seed()), embeddings.shape[0])
        return fit(self, embeddings, generator, perm, coreset)

    def maha_fit_with_jax_perm(self, embeddings, generator=None, perm=None, coreset=None):
        if perm is None:
            perm = jax_perm(int(generator.initial_seed()), embeddings.shape[0])
        return maha_fit(self, embeddings, generator, perm, coreset)

    monkeypatch.setattr(detector.AnomalyDetector, "fit", fit_with_jax_perm)
    monkeypatch.setattr(detector.MahalanobisDetector, "fit", maha_fit_with_jax_perm)
    with_jax_coreset_first(monkeypatch)
    monkeypatch.setattr(inf, "artificial_batches", jax_artificial_batches)


def with_jax_coreset_first(monkeypatch, first=None):
    """Make ``AnomalyDetector.fit``'s coreset start from JAX's first
    center: ``first``, or the one JAX draws from the fit's seed and the
    train split's row count (``jax_coreset_first``)."""
    from ssad_tpu_torch.models import detector

    select = detector.coreset_select

    def select_from_jax_first(embeddings, k, generator=None):
        start = first
        if start is None:
            start = jax_coreset_first(int(generator.initial_seed()), embeddings.shape[0])
        return select(embeddings, k, generator, start)

    monkeypatch.setattr(detector, "coreset_select", select_from_jax_first)


def infer_scorer_against_jax(fake_mvtec, models, tmp_path, capsys, monkeypatch, flags,
                             patch: bool, rtol: float, atol: float) -> None:
    """``cli infer [--patch-level] <flags>`` of the port (``--device cpu``,
    the JAX package's draws) against the JAX command, each from its own
    checkpoint of ``models`` (``write_checkpoints``): the same JSON line
    but for the threshold (``rtol``/``atol``) and the path, and
    ``inference.npz`` with the same keys, shapes and labels and the scores
    or maps within ``rtol``/``atol``."""
    import json

    from ssad_tpu import cli as jcli
    from ssad_tpu_torch import cli

    port_models, jax_models = models

    def common(root, out):
        return ["--dataset-dir", str(fake_mvtec), "--models-dir", str(root), "--outputs-dir",
                str(out), "--imsize", str(IMSIZE), "--batch-size", "8"]

    args = ["infer", "--subject", "bottle"] + (["--patch-level"] if patch else []) + flags
    assert jcli.main(args + common(jax_models, tmp_path / "jax")) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with_jax_draws(monkeypatch)
    assert cli.main(args + common(port_models, tmp_path / "port") + ["--device", "cpu"]) == 0
    (line,) = capsys.readouterr().out.strip().splitlines()
    got = json.loads(line)
    threshold = want.pop("threshold")
    assert abs(got.pop("threshold") - threshold) <= atol + rtol * abs(threshold)
    assert got.pop("outputs").endswith("bottle/inference.npz")
    want.pop("outputs")
    assert got == want == {"subject": "bottle", "mode": "patch" if patch else "image",
                           "n": 4 * 25 if patch else 4}
    with np.load(tmp_path / "port" / "bottle" / "inference.npz") as a, \
            np.load(tmp_path / "jax" / "bottle" / "inference.npz") as b:
        assert sorted(a.files) == sorted(b.files) == ["anomaly", "threshold", "y_hat", "y_true"]
        for k in a.files:
            assert a[k].shape == b[k].shape, k
        assert np.array_equal(a["y_true"], b["y_true"]) and np.array_equal(a["y_hat"], b["y_hat"])
        np.testing.assert_allclose(a["anomaly"], b["anomaly"], rtol=rtol, atol=atol)


def files_under(root) -> set:
    """Relative paths of the files under ``root``."""
    return {str(p.relative_to(root)) for p in root.rglob("*") if p.is_file()}


_NUMBER = re.compile(r"-?\d+\.\d+(?:e[-+]\d+)?|\bnan\b|\bNaN\b")


def table_parts(text: str):
    """A score table's text → (its layout: the text with every number
    blanked, runs of spaces and of a rule's dashes cut to one; the numbers
    in order).  The layout keeps the labels, the row and column order and
    each column's alignment (a Markdown rule's colons), not the widths
    that the printed digits set: ``g`` prints 0.843100 as ``0.8431`` and
    0.843108 in full, and the rule under it follows."""
    numbers = [float(m) for m in _NUMBER.findall(text)]
    return _NUMBER.sub("#", re.sub(r"-{2,}", "-", re.sub(r" +", " ", text))), numbers


def assert_tables_match(port_dir, jax_dir, tol: float):
    """Every table file of the JAX sweep exists in the port's with the same
    labels and layout, and numbers within ``tol`` plus one unit of the
    last printed digit."""
    names = sorted(p for p in files_under(jax_dir) if p.endswith((".csv", ".tex", ".md")))
    assert names and names == sorted(
        p for p in files_under(port_dir) if p.endswith((".csv", ".tex", ".md")))
    for name in names:
        (text, got), (jtext, want) = (table_parts((d / name).read_text())
                                      for d in (port_dir, jax_dir))
        assert text == jtext and len(got) == len(want), name
        digit = {".csv": 1e-4, ".tex": 1e-2, ".md": 1e-6}[Path(name).suffix]
        np.testing.assert_allclose(got, want, rtol=0, atol=tol + digit, err_msg=name)
