"""Dataset discovery on the MVTec-AD folder layout.

Counterpart of ssad_tpu/utils/filesystem.py:22-43 (the listing helpers
the patch-mode export reads).  Per category::

    <root>/<category>/train/good/*.png
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Sequence


def list_images(directory: str | Path, exts: Sequence[str] = (".png",)) -> List[str]:
    """Sorted image files directly inside ``directory``."""
    d = Path(directory)
    if not d.is_dir():
        return []
    return sorted(str(p) for p in d.iterdir() if p.is_file() and p.suffix.lower() in exts)


def train_good_images(category_dir: str | Path) -> List[str]:
    return list_images(Path(category_dir) / "train" / "good")
