"""The card a run measures: the refusal without one, and the record of it."""

from __future__ import annotations

import subprocess
from typing import Optional

import torch


class NoCard(RuntimeError):
    """The run asks for more cards than this machine has."""


def require_cards(chips: int) -> torch.device:
    """The first card, or NoCard: a run never falls back to the CPU."""
    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false: this benchmark runs on a CUDA card")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell needs {chips} cards, torch.cuda.device_count() is "
                     f"{torch.cuda.device_count()}")
    return torch.device("cuda", 0)


def power_limit() -> Optional[str]:
    """nvidia-smi's power limit of card 0 (a card may be set below its
    maximum), or None where nvidia-smi does not answer."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return proc.stdout.strip() or None


def record(device: torch.device, chips: int, peak_bytes: int) -> dict:
    """The result line's ``device`` object."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": int(peak_bytes)}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "memory_peak_bytes": int(peak_bytes), "power_limit": power_limit()}
