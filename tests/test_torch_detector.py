"""The port's AnomalyDetector and memory-bank views against the JAX
package's, with the JAX split permutation injected into the port so both
fit the same 70/30 split.  Scores and thresholds agree to 1e-5 (f32 sims
on both sides); the fitted bank rows are identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssad_tpu.models.detector import AnomalyDetector as JaxDetector
from ssad_tpu.train.memory_bank import MemoryBank as JaxBank
from ssad_tpu.train.memory_bank import newest_first as jax_newest_first
from ssad_tpu.utils.ref_checkpoint import bank_from_rows as jax_bank_from_rows
from ssad_tpu_torch.models.detector import AnomalyDetector
from ssad_tpu_torch.train.memory_bank import MemoryBank, newest_first
from ssad_tpu_torch.utils.ref_checkpoint import bank_from_rows

torch.set_num_threads(1)


def _fit_both(m, rule, seed=0):
    rng = np.random.default_rng(m)
    emb = rng.standard_normal((m, 64)).astype(np.float32)
    key = jax.random.key(seed)
    jdet = JaxDetector(k=3, threshold_rule=rule).fit(jnp.asarray(emb), key)
    perm = torch.from_numpy(np.asarray(jax.random.permutation(key, m)).astype(np.int64))
    det = AnomalyDetector(k=3, threshold_rule=rule).fit(torch.from_numpy(emb), perm=perm)
    return jdet, det, rng


@pytest.mark.parametrize("m, rule", [(40, "max"), (1000, "max"), (200, "quantile"), (5, "max")])
def test_fit_matches_jax(m, rule):
    jdet, det, rng = _fit_both(m, rule)
    np.testing.assert_array_equal(det.bank.numpy(), np.asarray(jdet.bank))
    np.testing.assert_allclose(
        det.calibration_scores.numpy(), np.asarray(jdet.calibration_scores), atol=1e-5, rtol=0
    )
    assert det.threshold == pytest.approx(jdet.threshold, abs=1e-5)

    q = rng.standard_normal((9, 64)).astype(np.float32)
    scores = det.predict(torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(scores, np.asarray(jdet.predict(jnp.asarray(q))), atol=1e-5, rtol=0)
    labels = det.predict_labels(torch.from_numpy(q)).numpy()
    clear = np.abs(scores - det.threshold) > 1e-5
    np.testing.assert_array_equal(labels[clear], np.asarray(jdet.predict_labels(jnp.asarray(q)))[clear])


def test_fit_with_generator_is_a_partition():
    emb = torch.from_numpy(np.random.default_rng(0).standard_normal((30, 8)).astype(np.float32))
    det = AnomalyDetector(k=3).fit(emb, generator=torch.Generator().manual_seed(1))
    assert det.bank.shape == (21, 8) and det.calibration_scores.shape == (9,)
    rows = {tuple(r) for r in det.bank.tolist()}
    assert len(rows) == 21 and rows <= {tuple(r) for r in emb.tolist()}
    with pytest.raises(ValueError, match="k\\+1"):
        AnomalyDetector(k=3).fit(emb[:3])
    with pytest.raises(RuntimeError):
        AnomalyDetector().predict(emb)


@pytest.mark.parametrize("rows, capacity", [(7, 1000), (1000, 1000), (1300, 1000), (0, 10)])
def test_bank_from_rows_and_newest_first_match_jax(rows, capacity):
    data = np.random.default_rng(rows).standard_normal((rows, 4)).astype(np.float32)
    ours = bank_from_rows(data, capacity=capacity)
    ref = jax_bank_from_rows(data, capacity=capacity)
    assert int(ours.cursor) == int(ref.cursor) and int(ours.count) == int(ref.count)
    np.testing.assert_array_equal(ours.data.numpy(), np.asarray(ref.data))
    np.testing.assert_array_equal(newest_first(ours).numpy(), np.asarray(jax_newest_first(ref)))


def test_newest_first_of_a_wrapped_ring_matches_jax():
    data = np.arange(24, dtype=np.float32).reshape(6, 4)
    ours = MemoryBank(torch.from_numpy(data), torch.tensor(2), torch.tensor(6))
    ref = JaxBank(jnp.asarray(data), jnp.asarray(2), jnp.asarray(6))
    np.testing.assert_array_equal(newest_first(ours).numpy(), np.asarray(jax_newest_first(ref)))


def test_reference_checkpoint_load_and_pickle_policy(tmp_path):
    import argparse

    from test_ref_checkpoint import lightning_checkpoint

    from ssad_tpu_torch.utils.ref_checkpoint import load_checkpoint

    ckpt = lightning_checkpoint(bank_rows=7)
    torch.save(ckpt, tmp_path / "best_model.ckpt")
    sd, bank, cfg, train_cfg = load_checkpoint(tmp_path / "best_model.ckpt")
    assert cfg.num_classes == 4 and cfg.memory_bank_size == 1000 and train_cfg is None
    assert cfg.compute_dtype == "bfloat16" and set(sd) == set(ckpt["state_dict"])
    # reference rows are oldest → newest; newest_first reverses them
    np.testing.assert_array_equal(newest_first(bank).numpy(), ckpt["memory_bank"].numpy()[::-1])

    with pytest.raises(FileNotFoundError):
        load_checkpoint(tmp_path / "missing.ckpt")
    ckpt["hyper_parameters"] = argparse.Namespace(num_classes=4)  # not a safe type
    torch.save(ckpt, tmp_path / "pickled.ckpt")
    with pytest.raises(ValueError, match="allow_pickle"):
        load_checkpoint(tmp_path / "pickled.ckpt")
    ckpt["hyper_parameters"] = {"num_classes": 4}
    ckpt["memory_bank"] = torch.tensor([])
    torch.save(ckpt, tmp_path / "nobank.ckpt")
    assert load_checkpoint(tmp_path / "nobank.ckpt")[1] is None
