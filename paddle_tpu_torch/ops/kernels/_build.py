"""Build and bind the port's CUDA kernels.

Each `paddle_tpu_torch/csrc/<name>.cu` is one shared library with a plain
C entry point, compiled by `nvcc` for Hopper (`sm_90a`) at first use and
loaded with `ctypes` — no PyTorch headers, so a build takes seconds.
Libraries go to `paddle_tpu_torch/_build/` (listed in .gitignore), named
by a hash of the source, the `csrc/` headers it includes (`#include
"x.cuh"`, followed through the headers) and the flags, so an edited
source or header rebuilds and an unchanged one loads from disk.  Only
sources in the package are built.

A build is counted as a compile in `observe.monitoring.runtime_stats`,
so a kernel built after a serving engine's warmup shows up as
`post_warmup_compiles > 0`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List

from ...observe.monitoring import runtime_stats

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
KERNEL_SOURCES = ("paged_attention", "flash_attention_fwd",
                  "flash_attention_bwd", "vocab_ce", "lstm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (on PATH or /usr/local/cuda/bin): the port's CUDA "
        "kernels build at first use and need the CUDA toolkit")


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def source_files(name: str) -> List[Path]:
    """`csrc/<name>.cu` and the `csrc/` headers it includes with a quoted
    `#include`, directly or through another header, in the order found."""
    files, todo = [], [CSRC_DIR / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in files:
            continue
        files.append(path)
        todo.extend(CSRC_DIR / inc
                    for inc in _INCLUDE.findall(path.read_text()))
    return files


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for path in source_files(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNEL_SOURCES) -> Dict[str, float]:
    """Compile every named kernel whose library is missing, one `nvcc`
    per source, all started together.  Returns {name: seconds} for the
    ones compiled.  Raises with the compiler's output on failure."""
    with _lock:
        return _build_locked(list(names))


def _build_locked(names) -> Dict[str, float]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT),
                       tmp, out)
    seconds = {}
    failures = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_bytes(log)
        if proc.returncode != 0:
            failures.append(f"{name}.cu (nvcc exit {proc.returncode}):\n"
                            f"{log.decode(errors='replace')}")
            continue
        os.replace(tmp, out)
        runtime_stats.record_compile(seconds[name])
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" +
                           "\n".join(failures))
    return seconds


def build_log(name: str) -> str:
    """The compiler's output (`-Xptxas -v`: registers, shared memory,
    spills) of the current build of `name`, or "" if it was not built in
    this checkout."""
    log = library_path(name).with_suffix(".log")
    return log.read_text(errors="replace") if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, building it first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _build_locked([name])
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
    return lib
