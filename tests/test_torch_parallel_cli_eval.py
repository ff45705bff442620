"""``cli evaluate --category-shards 2`` on the CPU: two categories
evaluated at once, one per worker thread, give the sequential sweep's
numbers (pixel AUROC, IoU and AUPRO within 1e-6, JAX's own bound,
tests/test_end_to_end.py), stdout, files and score tables; and
``evaluate --patch-level|infer --data-shards 2`` give the unsharded
command's numbers."""

import json

import numpy as np
import pytest
import torch
from _torch_eval import seeded_state_dict
from _torch_parallel import write_tree

from ssad_tpu_torch import cli
from ssad_tpu_torch.config import DataConfig, EvalConfig, ModelConfig, TrainConfig
from ssad_tpu_torch.evaluation.evaluator import evaluate_categories
from ssad_tpu_torch.train.checkpoint import save_checkpoint

torch.set_num_threads(1)

SUBJECTS = ("bottle", "carpet")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval")
    tree = write_tree(root / "tree", subjects=SUBJECTS)
    for i, s in enumerate(SUBJECTS):
        save_checkpoint(root / "models" / s, seeded_state_dict(i), None, TrainConfig(
            data=DataConfig(subject=s, imsize=(64, 64)),
            model=ModelConfig(compute_dtype="float32")))
    return tree, root / "models"


def _files(root):
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file() and p.suffix in (".csv", ".md", ".tex")}


def test_category_shards_equal_the_sequential_sweep(setup, tmp_path, capsys):
    tree, models = setup
    base = ["evaluate", "--dataset-dir", str(tree), "--models-dir", str(models),
            "--subjects", ",".join(SUBJECTS), "--imsize", "64", "--batch-size", "4",
            "--patch-level", "--device", "cpu"]
    outs = {}
    for name, extra in (("sequential", []), ("sharded", ["--category-shards", "2"])):
        assert cli.main(base + ["--outputs-dir", str(tmp_path / name)] + extra) == 0
        outs[name] = capsys.readouterr().out.strip().splitlines()
    assert outs["sharded"] == outs["sequential"] and len(outs["sharded"]) == 2
    assert _files(tmp_path / "sharded") == _files(tmp_path / "sequential")
    pngs = {str(p.relative_to(tmp_path / "sharded")) for p in (tmp_path / "sharded").rglob("*.png")}
    assert {f"{s}/{s}_pixel_roc.png" for s in SUBJECTS} <= pngs


def test_library_numbers_within_1e_6(setup, tmp_path):
    tree, models = setup
    cfg = EvalConfig(patch_localization=True, imsize=(64, 64), batch_size=4)
    seq = evaluate_categories(tree, models, SUBJECTS, cfg, str(tmp_path / "a"), device="cpu")
    par = evaluate_categories(tree, models, SUBJECTS, EvalConfig(
        patch_localization=True, imsize=(64, 64), batch_size=4, category_shards=2),
        str(tmp_path / "b"), device="cpu")
    for s in SUBJECTS:
        for k in ("pixel_auroc", "iou", "aupro"):
            assert abs(getattr(par[s], k) - getattr(seq[s], k)) <= 1e-6, (s, k)


@pytest.mark.parametrize("command", ["evaluate", "infer"])
def test_data_shards_equal_the_unsharded_command(setup, tmp_path, capsys, command):
    tree, models = setup
    argv = [command, "--dataset-dir", str(tree), "--models-dir", str(models), "--imsize", "64",
            "--batch-size", "4", "--device", "cpu"]
    # evaluate at patch level (its image level adds the t-SNE and Grad-CAM,
    # ~7 s a run here, which shard nothing); infer at image level
    argv += (["--subjects", "bottle", "--patch-level"] if command == "evaluate"
             else ["--subject", "bottle"])
    got = {}
    for shards in ("1", "2"):
        out = tmp_path / shards
        assert cli.main(argv + ["--outputs-dir", str(out), "--data-shards", shards]) == 0
        got[shards] = capsys.readouterr().out.strip().splitlines()
    if command == "infer":
        a, b = (json.loads(got[s][-1]) for s in ("1", "2"))
        assert abs(a["threshold"] - b["threshold"]) <= 1e-5 and a["n"] == b["n"]
        with np.load(tmp_path / "1" / "bottle" / "inference.npz") as x, \
                np.load(tmp_path / "2" / "bottle" / "inference.npz") as y:
            np.testing.assert_allclose(y["anomaly"], x["anomaly"], rtol=1e-5, atol=1e-5)
            assert np.array_equal(y["y_hat"], x["y_hat"])
    else:
        assert got["2"] == got["1"]
