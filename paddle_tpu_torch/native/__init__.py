"""Native (C++) host components, loaded via ctypes: the port of
paddle_tpu/native/__init__.py.

The reference keeps its record IO in C++ (reference:
paddle/fluid/recordio/*.cc); the chunk codec lives in `recordio.cc` here
(the port's copy of paddle_tpu/native/recordio.cc) and binds through its
C ABI.  It is built at first use with
`g++ -O2 -shared -fPIC recordio.cc -lz` into `paddle_tpu_torch/_build/`
(listed in .gitignore), named by a hash of the source and the flags as
the CUDA kernels are (ops/kernels/_build.py), never inside the package's
source folders.  Without a C++ toolchain or zlib the build fails and
`recordio_lib()` returns None: data/recordio.py then runs its pure-Python
codec, the reference's documented fallback, and `recordio.codec()` says
which one ran.  This is a host codec, not a device kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

SRC = Path(__file__).resolve().parent / "recordio.cc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O2", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None
_tried = False
build_error: Optional[str] = None   # why the last build failed, if it did


def library_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"librecordio-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> bool:
    """g++ the codec into `out` (through a temporary name in the same
    folder, renamed at the end, so concurrent builders never load a half
    written library)."""
    global build_error
    cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SRC), "-lz"],
                              capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            build_error = proc.stderr[-2000:]
            return False
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.SubprocessError) as e:
        build_error = f"{type(e).__name__}: {e}"
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def recordio_lib() -> Optional[ctypes.CDLL]:
    """The native codec, built on first use; None when unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = library_path()
        if not path.exists() and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        lib.rio_encode_bound.restype = ctypes.c_longlong
        lib.rio_encode_bound.argtypes = [ctypes.c_longlong, ctypes.c_int]
        lib.rio_encode_chunk.restype = ctypes.c_longlong
        lib.rio_encode_chunk.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint32), ctypes.c_int,
            ctypes.c_int, ctypes.c_char_p, ctypes.c_longlong]
        lib.rio_decode_chunk.restype = ctypes.c_int
        lib.rio_decode_chunk.argtypes = [
            ctypes.c_char_p, ctypes.c_longlong, ctypes.c_char_p,
            ctypes.c_longlong, ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_longlong, ctypes.POINTER(ctypes.c_int)]
        _lib = lib
        return _lib
