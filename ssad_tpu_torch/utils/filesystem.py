"""Dataset discovery on the MVTec-AD folder layout.

Counterpart of ssad_tpu/utils/filesystem.py:22-93.  Per category::

    <root>/<category>/train/good/*.png
    <root>/<category>/test/<defect>/*.png
    <root>/<category>/ground_truth/<defect>/*_mask.png
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional, Sequence


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


def test_images(category_dir: str | Path) -> List[str]:
    """All test images across defect-type subfolders: the folders in
    sorted order, each one's files sorted (functional.py:53-61)."""
    test_dir = Path(category_dir) / "test"
    if not test_dir.is_dir():
        return []
    out: List[str] = []
    for sub in sorted(p for p in test_dir.iterdir() if p.is_dir()):
        out.extend(list_images(sub))
    return out


# a helper, not a test, whatever its name says
test_images.__test__ = False


def ground_truth_path(test_filename: str | Path) -> Optional[str]:
    """``.../<cat>/test/<defect>/<name>.png`` →
    ``.../<cat>/ground_truth/<defect>/<name>_mask.png``; None for 'good'
    images (functional.py:43-50)."""
    p = Path(test_filename)
    defect = p.parent.name
    if defect == "good":
        return None
    return str(p.parent.parent.parent / "ground_truth" / defect / f"{p.stem}_mask{p.suffix}")


def duplicate_to_length(filenames: Sequence[str], min_length: int) -> List[str]:
    """The whole list repeated until it holds at least ``min_length``
    names (functional.py:64-68): order kept, never trimmed."""
    files = list(filenames)
    if not files:
        return []
    out = list(files)
    while len(out) < min_length:
        out.extend(files)
    return out


def ensure_dir(path: str | Path) -> Path:
    p = Path(path)
    os.makedirs(p, exist_ok=True)
    return p
