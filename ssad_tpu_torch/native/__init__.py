"""Native (C++) host components of the port, built with g++ at first use.

Counterpart of ssad_tpu/native/__init__.py: ``build_library`` (:39-70)
and the threaded PNG/JPEG loader (``loader.cpp``, bound here with ctypes:
``build``, ``available``, ``decode_resize_batch``, :71-170, behind
data/mvtec.py's ``load_stack`` and ``load_mask_stack``).  The other
native component is the HTTP front end (``http_frontend.cpp``, bound by
serving/native_frontend.py).

Build model: ``g++ -O3 -shared -fPIC -std=c++17 -pthread`` into the
git-ignored ``ssad_tpu_torch/_build/``, beside the nvcc libraries of
ops/_cuda.py, as ``lib<name>-<hash>.so``; the hash covers the source and
the flags, so an edited source is rebuilt, and a build writes a
temporary file and renames it into place, so concurrent builds
converge on one file.  ``SSAD_NATIVE=0`` disables every native component:
``build_library`` then builds nothing and returns None.  The front end
then falls back with a warning; the loader falls back to PIL, as the JAX
package's does, and ``cli doctor`` reports whether it was built.  Nothing
is built at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

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


# --- the threaded PNG/JPEG loader (loader.cpp) ---------------------------------

_LOADER_SRC = NATIVE_DIR / "loader.cpp"
_loader_lock = threading.Lock()
_loader: Optional[ctypes.CDLL] = None
_loader_tried = False


def build() -> Optional[Path]:
    """Compile loader.cpp if needed; its library's path, or None."""
    return build_library(_LOADER_SRC, "ssadloader", ("-lpng", "-ljpeg"))


def _load() -> Optional[ctypes.CDLL]:
    """The loader's library, built and bound on first use; None when it
    cannot be (``SSAD_NATIVE=0``, no g++, no libpng/libjpeg headers)."""
    global _loader, _loader_tried
    with _loader_lock:
        if _loader_tried:
            return _loader
        _loader_tried = True
        so = build()
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            return None
        lib.ssad_decode_resize_batch.restype = ctypes.c_int
        lib.ssad_decode_resize_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.ssad_probe.restype = ctypes.c_int
        lib.ssad_probe.argtypes = []
        if lib.ssad_probe() == 1:
            _loader = lib
        return _loader


def available() -> bool:
    """True when the native loader is built and loadable."""
    return _load() is not None


def _png_needs_pil(path) -> bool:
    """True for PNGs the native path must not decode: palette (colour
    type 3) and alpha (4, 6) images go through libpng's compositing, and
    16-bit depths through its rescaling, with other results than PIL's
    ``convert('RGB')``, which the pipeline is defined against.  Read from
    the IHDR header (26 bytes): 8-bit grayscale (0) and truecolour (2) are
    the formats whose libpng → RGB conversion matches PIL."""
    try:
        with open(path, "rb") as f:
            head = f.read(26)
    except OSError:
        return True
    if len(head) < 26 or head[12:16] != b"IHDR":
        return True
    bit_depth, color_type = head[24], head[25]
    return bit_depth != 8 or color_type not in (0, 2)


def _supported(paths: Sequence[str]) -> bool:
    for p in paths:
        s = str(p).lower()
        if s.endswith(".png"):
            if _png_needs_pil(p):
                return False
        elif not s.endswith((".jpg", ".jpeg")):
            return False
    return True


def decode_resize_batch(
    paths: Sequence[str],
    imsize: Tuple[int, int],
    channels: int = 3,
    n_threads: int = 0,
) -> Optional[np.ndarray]:
    """Decode + bicubic-resize files to (N, H, W, C) float32 in [0, 1].

    Returns None when the loader is unavailable, a file is of a kind it
    leaves to PIL (``_png_needs_pil``, neither PNG nor JPEG), or a file
    fails to decode: the caller then takes the PIL path.  n_threads=0 →
    the host's core count.  The native path decodes to the target mode
    before resizing, which equals PIL's resize-then-convert for RGB and
    grayscale sources; its resize is within 2/255 of PIL's."""
    lib = _load()
    if lib is None or not _supported(paths):
        return None
    n = len(paths)
    h, w = imsize
    out = np.zeros((n, h, w, channels), np.float32)
    if n == 0:
        return out
    arr = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    err = ctypes.c_int(-1)
    failures = lib.ssad_decode_resize_batch(
        arr, n, h, w, channels,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n_threads, ctypes.byref(err),
    )
    if failures:
        return None
    return out
