"""The control of ``correct`` comes out not correct: the reference in fp8
put in the program's place fails a cell's limits, where the program's own
run passes them.  On the card at each cell's own size and three seeds
(``card``); here at a tiny size on the CPU."""

import importlib.util

import pytest
import torch

from pb_helpers import ROOT, add_tiny_cell
from port_bench.core import manifest

spec = importlib.util.spec_from_file_location("pb_control", ROOT / "port_bench" / "control.py")
control = importlib.util.module_from_spec(spec)
spec.loader.exec_module(control)


def fails(cell, numbers) -> bool:
    return any(numbers[name] > limit for name, limit in cell.limits.items())


@pytest.mark.parametrize("mode", ["patch", "image"])
def test_fp8_control_fails_tiny(tmp_path, mode):
    cell = manifest.resolve_cell(add_tiny_cell(tmp_path, mode), root=tmp_path)
    readings = control.control_readings(cell, 2**31 + 21, torch.device("cpu"))
    assert fails(cell, readings["fp8"]), readings


@pytest.mark.card
@pytest.mark.parametrize("cell_name", [w["name"] for w in manifest.load_manifest()["workloads"]])
def test_fp8_control_fails_on_the_card(cuda_device, cell_name):
    cell = manifest.resolve_cell(cell_name)
    for seed in (3100000011, 3100000012, 3100000013):
        readings = control.control_readings(cell, seed, cuda_device)
        assert fails(cell, readings["fp8"]), (seed, readings)
