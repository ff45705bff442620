"""The evaluation half of ``run_parity`` in both packages
(tests/test_torch_parity*.py): each skips training on its own checkpoint
of the same f32 weights, the port draws as the JAX package does
(``_torch_eval.with_jax_draws``), and the summaries, fingerprints and
tables are compared."""

import json
import shutil

import pytest
from _torch_eval import assert_tables_match, seeded_state_dict, with_jax_draws, write_checkpoints

from ssad_tpu import parity as jparity
from ssad_tpu_torch import parity

#: the port's summary against JAX's: the evaluate tests' tolerances (image
#: 2e-3, the artificial table's AUROC: tests/test_torch_eval_cli.py; pixel
#: 1e-3: tests/test_torch_evaluator_patch.py)
TOL = {"image": 2e-3, "patch": 1e-3}
#: the synthetic trees both runs reuse (their manifest covers the run):
#: fewer images than ``generate_parity_dataset``'s defaults, at 64²
IMSIZE, N_TRAIN, N_TEST_GOOD, N_TEST_DEFECT = 64, 8, 2, 3


def check_evaluation_half(root, mode: str, subjects) -> None:
    """Both packages' ``run_parity`` in ``mode`` on ``subjects``, with the
    checkpoints in ``<out>/<mode>_level/models/<subject>/`` and a small
    synthetic tree already in ``<out>/synthetic_dataset``."""
    port_models, jax_models = write_checkpoints(root / "ck", subjects, seeded_state_dict(0))
    for models, out in ((port_models, "port_out"), (jax_models, "jax_out")):
        (root / out / f"{mode}_level").mkdir(parents=True)
        shutil.move(str(models), str(root / out / f"{mode}_level" / "models"))
        parity.generate_parity_dataset(root / out / "synthetic_dataset", subjects, imsize=IMSIZE,
                                       n_train=N_TRAIN, n_test_good=N_TEST_GOOD,
                                       n_test_defect=N_TEST_DEFECT)
    kw = dict(dataset_dir=None, subjects=subjects, imsize=IMSIZE, modes=(mode,), verbose=False)
    want = jparity.run_parity(outputs_dir=str(root / "jax_out"), **kw)
    mp = pytest.MonkeyPatch()
    with_jax_draws(mp)
    try:
        got = parity.run_parity(outputs_dir=str(root / "port_out"), device="cpu", **kw)
    finally:
        mp.undo()
    tol = TOL[mode]
    assert got.keys() == want.keys() == {mode}
    got, want = got[mode], want[mode]
    assert got["reference"] == want["reference"]
    assert got["per_subject"].keys() == want["per_subject"].keys() == set(subjects)
    for s, row in want["per_subject"].items():
        assert row.keys() == got["per_subject"][s].keys()
        for metric, value in row.items():
            assert abs(got["per_subject"][s][metric] - value) <= tol, (s, metric)
    assert got.keys() == want.keys()
    for metric in (k for k in want if k not in ("reference", "per_subject")):
        assert abs(got[metric] - want[metric]) <= tol, metric
    port, jax = root / "port_out", root / "jax_out"
    assert json.loads((port / "parity_summary.json").read_text()) == \
        json.loads(json.dumps({mode: got}))
    assert (port / "PARITY_SUMMARY.md").exists()
    fingerprint = f"{mode}_level/models/parity_run.json"
    assert (port / fingerprint).read_text() == (jax / fingerprint).read_text()
    assert_tables_match(port / f"{mode}_level" / "tables", jax / f"{mode}_level" / "tables", tol)
