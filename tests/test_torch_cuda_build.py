"""How the port's CUDA libraries are named (ssad_tpu_torch/ops/_cuda.py),
checked without a card or nvcc: a library's file name follows its source,
every header in csrc/ and the flags, so that an edit to the shared launch
helpers (csrc/launch.cuh) rebuilds every kernel; and every header a source
includes by quotes is one of those hashed headers."""

import re

import pytest

from ssad_tpu_torch.ops import _cuda

SOURCES = sorted(p.stem for p in _cuda.CSRC_DIR.glob("*.cu"))


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    monkeypatch.setattr(_cuda, "CSRC_DIR", tmp_path)
    (tmp_path / "a.cu").write_text('#include "launch.cuh"\nint a;\n')
    (tmp_path / "launch.cuh").write_text("int helper;\n")
    return tmp_path


@pytest.mark.parametrize("edit", ["source", "header", "new header", "flags"])
def test_the_library_name_follows_every_input(csrc, monkeypatch, edit):
    before = _cuda.library_path("a")
    assert before.name.startswith("liba-") and before.suffix == ".so"
    assert _cuda.library_path("a") == before
    if edit == "source":
        (csrc / "a.cu").write_text('#include "launch.cuh"\nint a, b;\n')
    elif edit == "header":
        (csrc / "launch.cuh").write_text("int helper, other;\n")
    elif edit == "new header":
        (csrc / "more.cuh").write_text("int more;\n")
    else:
        monkeypatch.setattr(_cuda, "NVCC_FLAGS", _cuda.NVCC_FLAGS + ("-lineinfo",))
    assert _cuda.library_path("a") != before


@pytest.mark.parametrize("name", SOURCES)
def test_every_source_includes_only_hashed_headers(name):
    src = (_cuda.CSRC_DIR / f"{name}.cu").read_text()
    local = re.findall(r'^#include "([^"]+)"', src, re.M)
    assert "launch.cuh" in local  # the shared helpers, not a copy of them
    assert all((_cuda.CSRC_DIR / h).is_file() and h.endswith(".cuh") for h in local)
    assert "int on_device(" not in src
