"""``python -m ssad_tpu_torch.cli evaluate --patch-level`` against the
JAX command on fake_mvtec's bottle, each from its own checkpoint of the
same f32 weights, the port on ``--device cpu`` with the JAX fit
permutation: the same stdout line (pixel AUROC, IoU, AUPRO to 4
decimals), every file the JAX command writes, the tables' labels and
numbers within 1e-3 (measured at most 6.3e-6: tests/
test_torch_evaluator_patch.py).  ``cli infer``:
tests/test_torch_infer_cli.py."""

from _torch_port import jax_masks_on_the_numpy_path  # noqa: F401  (autouse fixture)
from _torch_eval import (
    IMSIZE, assert_tables_match, files_under, seeded_state_dict, with_jax_draws,
    write_checkpoints,
)

from ssad_tpu import cli as jcli
from ssad_tpu_torch import cli


def _common(data, models, out):
    return ["--dataset-dir", str(data), "--models-dir", str(models), "--outputs-dir", str(out),
            "--imsize", str(IMSIZE), "--batch-size", "8"]


def test_cli_evaluate_patch_level_matches_jax(fake_mvtec, tmp_path, capsys, monkeypatch):
    port_models, jax_models = write_checkpoints(tmp_path, ["bottle"], seeded_state_dict(0))
    args = ["evaluate", "--subjects", "bottle", "--patch-level"]
    assert jcli.main(args + _common(fake_mvtec, jax_models, tmp_path / "jax_out")) == 0
    want = capsys.readouterr().out.strip().splitlines()
    with_jax_draws(monkeypatch)
    assert cli.main(args + _common(fake_mvtec, port_models, tmp_path / "port_out")
                    + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out.strip().splitlines()
    assert got == want and got[0].startswith("bottle: pixel_auroc=")
    assert files_under(tmp_path / "port_out") == files_under(tmp_path / "jax_out")
    assert_tables_match(tmp_path / "port_out" / "tables", tmp_path / "jax_out" / "tables", 1e-3)
