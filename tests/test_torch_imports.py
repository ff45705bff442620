"""Guards of the port's boundaries: it imports neither JAX nor anything of
the JAX package, and it runs on the CPU only when asked to."""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "ssad_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
    for p in PORT.rglob("*.py")
)


def test_slice_modules_import_without_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'ssad_tpu', 'matplotlib', 'sklearn', 'pandas', 'cv2'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert len(MODULES) >= 56, len(MODULES)  # a dropped module fails here
    for m in ("ssad_tpu_torch.ops.coreset", "ssad_tpu_torch.evaluation.evaluator", "ssad_tpu_torch.evaluation.metrics",
              "ssad_tpu_torch.evaluation.metrics_device", "ssad_tpu_torch.evaluation.error_analysis",
              "ssad_tpu_torch.models.gradcam", "ssad_tpu_torch.utils.convert",
              "ssad_tpu_torch.evaluation.tsne", "ssad_tpu_torch.evaluation.localizer",
              "ssad_tpu_torch.serving.quant", "ssad_tpu_torch.serving.client",
              "ssad_tpu_torch.serving.loadgen", "ssad_tpu_torch.serving.replicas",
              "ssad_tpu_torch.serving.native_frontend", "ssad_tpu_torch.native",
              "ssad_tpu_torch.parity", "ssad_tpu_torch.utils.profiling"):
        assert m in MODULES, m


#: the JAX stack and the JAX package, and the host libraries the card
#: machine lacks (matplotlib, sklearn, pandas, OpenCV)
_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|flax|optax|orbax|matplotlib|sklearn|pandas|cv2)\b"
    r"|from\s+(jax|flax|optax|orbax|matplotlib|sklearn|pandas|cv2)\b"
    r"|import\s+ssad_tpu(\s|$|\.|,)|from\s+ssad_tpu(\s|\.)(?!_torch))",
    re.MULTILINE,
)


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(ROOT)) for p in PORT.rglob("*.py"))
    + ["chip_smoke.py"]
    + sorted(str(p.relative_to(ROOT)) for p in (ROOT / "scripts").glob("torch_*.py")),
)
def test_no_jax_or_jax_package_imports_in_source(path):
    src = (ROOT / path).read_text()
    assert not _FORBIDDEN.findall(src), path


def test_forbidden_pattern_catches_the_jax_package():
    for line in ("import jax", "from jax import numpy", "import ssad_tpu",
                 "from ssad_tpu.ops import knn", "from ssad_tpu import config",
                 "    import flax.linen as nn", "import optax", "    import matplotlib",
                 "import matplotlib.pyplot as plt", "from sklearn.manifold import TSNE",
                 "import pandas as pd", "import cv2", "    from cv2 import Canny"):
        assert _FORBIDDEN.search(line), line
    for line in ("from ssad_tpu_torch.ops import knn", "import ssad_tpu_torch"):
        assert not _FORBIDDEN.search(line), line


def test_resolve_device_defaults_to_cuda_or_raises():
    from ssad_tpu_torch.utils.device import DeviceUnavailable, resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(DeviceUnavailable, match="--device cpu"):
            resolve_device(None)
        with pytest.raises(DeviceUnavailable):
            resolve_device("cuda")


@pytest.mark.parametrize("command", ["score", "qa", "train", "evaluate", "infer", "parity",
                                     "profile"])
def test_cli_without_device_flag_refuses_the_cpu(tmp_path, command):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    (tmp_path / "x.npy").write_bytes(b"")
    args = {
        "score": ["--artifact", str(tmp_path / "missing.ssadpt"), str(tmp_path / "x.npy")],
        "qa": ["--dataset-dir", str(tmp_path), "--subject", "bottle"],
        "train": ["--dataset-dir", str(tmp_path), "--subject", "bottle"],
        "evaluate": ["--dataset-dir", str(tmp_path), "--models-dir", str(tmp_path)],
        "infer": ["--dataset-dir", str(tmp_path), "--models-dir", str(tmp_path),
                  "--subject", "bottle"],
        "parity": ["--outputs-dir", str(tmp_path / "parity")],
        "profile": ["--dataset-dir", str(tmp_path), "--subject", "bottle", "--profile-dir",
                    str(tmp_path / "trace")],
    }[command]
    proc = subprocess.run(
        [sys.executable, "-m", "ssad_tpu_torch.cli", command, *args],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr and "--device cpu" in proc.stderr
