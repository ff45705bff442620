"""Native (C++) host components of the port, built with g++ at first use.

Counterpart of ssad_tpu/native/__init__.py:39-70 (``build_library``).
The one native component so far is the HTTP front end
(``http_frontend.cpp``, bound by serving/native_frontend.py with ctypes).

Build model: ``g++ -O3 -shared -fPIC -std=c++17 -pthread`` into the
git-ignored ``ssad_tpu_torch/_build/``, beside the nvcc libraries of
ops/_cuda.py, as ``lib<name>-<hash>.so``; the hash covers the source and
the flags, so an edited source is rebuilt, and a build writes a
temporary file and renames it into place, so concurrent builds
converge on one file.  ``SSAD_NATIVE=0`` disables every native component:
``build_library`` then builds nothing and returns None, and callers fall
back loudly.  Nothing is built at import time.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

NATIVE_DIR = Path(__file__).resolve().parent
BUILD_DIR = NATIVE_DIR.parent / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

#: seconds each library's g++ build took in this process, by name
build_s: Dict[str, float] = {}


def library_path(src_path: Path, name: str, libs: Sequence[str] = ()) -> Path:
    digest = hashlib.sha256(
        src_path.read_bytes() + " ".join((*CXX_FLAGS, *libs)).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_library(src_path: Path, name: str, libs: Sequence[str] = ()) -> Optional[Path]:
    """Compile one .cpp into a shared library under ``_build/``; returns
    its path, or None when ``SSAD_NATIVE=0``, the source is missing or
    g++ fails."""
    if os.environ.get("SSAD_NATIVE", "1") == "0" or not src_path.exists():
        return None
    out = library_path(src_path, name, libs)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = ["g++", *CXX_FLAGS, str(src_path), *libs, "-o", str(tmp)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, out)  # atomic: concurrent builds converge on one file
    build_s[name] = time.perf_counter() - t0
    return out
