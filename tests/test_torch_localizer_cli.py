"""``python -m ssad_tpu_torch.cli localize`` against the JAX command
(ssad_tpu/cli.py:388-410) on fake_mvtec's bottle, each from its own
checkpoint of the same seeded f32 weights (``_torch_eval.
write_checkpoints``), the port on ``--device cpu``: for the same
``--seed`` both print and write the same panel files
(``<subject>_<defect>_<stem>_panel.png``; the test images are sampled by
``np.random.default_rng(seed)`` in both), at both levels.  The maps
themselves: tests/test_torch_localizer.py.

The JAX package's object masks here are its OpenCV path's, which the
port computes bit for bit without OpenCV: these comparisons need
OpenCV on the machine that runs the tests (without it the JAX package
takes its numpy fallback, which the port does not compute)."""

import numpy as np
import pytest
import torch
from _torch_eval import IMSIZE, seeded_state_dict, write_checkpoints

from ssad_tpu.evaluation import visualization as jvis
from ssad_tpu_torch import cli

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    return write_checkpoints(tmp_path_factory.mktemp("localize_models"), ["bottle"],
                             seeded_state_dict(0))


@pytest.mark.parametrize("patch", [False, True], ids=["image", "patch"])
def test_cli_localize_writes_the_jax_panels(fake_mvtec, models, tmp_path, capsys, monkeypatch,
                                            patch):
    from ssad_tpu import cli as jcli

    port_models, jax_models = models
    # the JAX panel draws with matplotlib; only its file name is compared
    monkeypatch.setattr(jvis, "localization_panel",
                        lambda o, a, g, p, path, name: jvis.save_image(
                            np.zeros((1, 1, 3), np.uint8), path + "/" + name))

    def args(models, out):
        return (["localize", "--dataset-dir", str(fake_mvtec), "--models-dir", str(models),
                 "--subject", "bottle", "--imsize", str(IMSIZE), "--outputs-dir", str(out),
                 "--num-images", "3", "--seed", "4"] + (["--patch-level"] if patch else []))

    assert jcli.main(args(jax_models, tmp_path / "jax_out")) == 0
    want = capsys.readouterr().out.strip().splitlines()
    assert cli.main(args(port_models, tmp_path / "port_out") + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out.strip().splitlines()
    names = lambda lines: [line.rsplit("/", 1)[1] for line in lines]  # noqa: E731
    assert len(got) == 3 and names(got) == names(want)
    assert sorted(p.name for p in (tmp_path / "port_out" / "bottle").iterdir()) == \
        sorted(names(want))
