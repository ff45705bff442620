"""Dataset discovery on the MVTec-AD folder layout.

Counterpart of ssad_tpu/utils/filesystem.py:22-43 (the listing helpers
the patch-mode export and the synthesizer's cut pool read).  Per category::

    <root>/<category>/train/good/*.png
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Sequence


def list_categories(dataset_dir: str | Path) -> List[str]:
    """Sorted sub-directories of the dataset root (one per category)."""
    root = Path(dataset_dir)
    if not root.is_dir():
        return []
    return sorted(p.name for p in root.iterdir() if p.is_dir())


def list_images(directory: str | Path, exts: Sequence[str] = (".png",)) -> List[str]:
    """Sorted image files directly inside ``directory``."""
    d = Path(directory)
    if not d.is_dir():
        return []
    return sorted(str(p) for p in d.iterdir() if p.is_file() and p.suffix.lower() in exts)


def train_good_images(category_dir: str | Path) -> List[str]:
    return list_images(Path(category_dir) / "train" / "good")
