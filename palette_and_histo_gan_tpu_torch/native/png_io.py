"""ctypes bindings for the native PNG decoder (native/png_decode.cpp).

The library is compiled at its first use in a process with the host C++
compiler (`g++ -O2 -shared -fPIC -std=c++17 ... -lz`) into `build/native/`
at the repository root, under a name that carries a hash of the source, so
an edited source is rebuilt and an unchanged one loaded as it is. Every
entry point returns None when the library cannot be built or loaded (no
compiler, no zlib) or a file is a format it does not decode; the callers
then decode with PIL. `build_error` says why the library is missing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import tempfile

import numpy as np

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "png_decode.cpp")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "native",
)
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lib = None
_tried = False
_error = None  # why the library could not be built


def _build() -> tuple[str | None, str | None]:
    """(path of the built library, compiling it if needed, None); on
    failure (None, why)."""
    compiler = shutil.which("g++")
    if compiler is None:
        return None, "no g++ on PATH"
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    target = os.path.join(BUILD_DIR, f"libphg_png-{digest}.so")
    if os.path.exists(target):
        return target, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    # compile to a private file and rename, so concurrent builds never load
    # a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run(
        [compiler, *CXX_FLAGS, SOURCE, "-lz", "-o", tmp], capture_output=True, text=True,
    )
    if proc.returncode != 0:
        os.unlink(tmp)
        return None, f"g++ exited {proc.returncode}:\n{proc.stderr.strip()}"
    os.replace(tmp, target)
    return target, None


def _load():
    global _lib, _tried, _error
    if _tried:
        return _lib
    _tried = True
    path, _error = _build()
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    lib.phg_decode_png_file.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_long, ctypes.c_long,
    ]
    lib.phg_decode_png_file.restype = ctypes.c_int
    lib.phg_decode_folder.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_long, ctypes.c_long, ctypes.c_long,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.phg_decode_folder.restype = ctypes.c_int
    _lib = lib
    return lib


def build_error() -> str | None:
    """Why the library could not be built (the compiler's stderr), or None
    when it loaded or was not needed yet."""
    return _error


def decode_png_rgba(path: str, h: int = 64, w: int = 64) -> np.ndarray | None:
    """Decode one PNG to (h, w, 4) uint8; None if the library is missing or
    the file is an unsupported format."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty((h, w, 4), dtype=np.uint8)
    rc = lib.phg_decode_png_file(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w
    )
    return out if rc == 0 else None


def decode_folder(folder: str, n: int, h: int = 64, w: int = 64, start: int = 0):
    """Decode <folder>/<start+i>.png for i in [0, n) in one native call:
    (n, h, w, 4) uint8, or None on failure."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty((n, h, w, 4), dtype=np.uint8)
    rc = lib.phg_decode_folder(
        folder.encode(), start, n, h, w, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out if rc == 0 else None


PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def png_header(path: str) -> tuple[int, int, int]:
    """(height, width, colour type) from a PNG's IHDR chunk, which the
    format puts first."""
    with open(path, "rb") as f:
        head = f.read(26)
    if len(head) < 26 or head[:8] != PNG_MAGIC or head[12:16] != b"IHDR":
        raise ValueError(f"{path} is not a PNG")
    width, height = struct.unpack(">II", head[16:24])
    return height, width, head[25]
