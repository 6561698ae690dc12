"""Build the CUDA kernels under ``csrc/`` into one shared library with a
plain C interface, at first use, and load it with ctypes.

Each ``.cu`` source is compiled by its own ``nvcc`` process, all started
together, then linked into ``_build/libkernels_<hash>.so``. The hash covers
the sources, the header and the flags, so an edited source rebuilds. Needs
``nvcc`` (on PATH, under $CUDA_HOME, or /usr/local/cuda); no PyTorch
headers, no ninja.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("wedge_colors.cu", "wedge_render.cu", "flash_attn_fwd.cu",
           "flash_attn_bwd.cu")
HEADERS = ("wedge_common.cuh",)
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "wedge_colors_launch": [_P, _P, _P, _I, _I, _F, _F, _P],
    "wedge_render_launch": [_P] * 9 + [_I, _I, _I, _F, _F, _I] + [_F] * 8 + [_P],
    "flash_attn_fwd_launch": [_P] * 5 + [_I, _I, _F, _P],
    "flash_attn_bwd_dkv_launch": [_P] * 8 + [_I, _I, _F, _P],
    "flash_attn_bwd_dq_launch": [_P] * 7 + [_I, _I, _F, _P],
}


class Library:
    """The loaded kernels, with how they were built."""

    def __init__(self, cdll: ctypes.CDLL, path: Path, build_seconds: float,
                 log: str):
        self.cdll = cdll
        self.path = path
        self.build_seconds = build_seconds  # 0.0 when the library was cached
        self.log = log                      # nvcc/ptxas output of the build
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(cdll, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int


_library = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _compile(target: Path) -> str:
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for name in SOURCES:
            obj = Path(tmp) / (name + ".o")
            cmd = [nvcc, *FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, failed = [], []
        for name, _, proc in procs:  # wait for every compiler, failed or not
            out, _ = proc.communicate()
            log.append(f"== {name}\n{out}")
            if proc.returncode != 0:
                failed.append(name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        so = Path(tmp) / target.name
        link = subprocess.run(
            [nvcc, "-shared", *FLAGS[:2], *[str(o) for _, o, _ in procs],
             "-o", str(so)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(so, target)  # atomic: a reader never sees half a library
    return "\n".join(log)


def load_library() -> Library:
    """The kernels' library, built on the first call of the process (or
    found in ``_build/`` from an earlier build of the same sources)."""
    global _library
    if _library is None:
        target = BUILD_DIR / f"libkernels_{_digest()}.so"
        t0 = time.perf_counter()
        log = "" if target.exists() else _compile(target)
        seconds = time.perf_counter() - t0 if log else 0.0
        _library = Library(ctypes.CDLL(str(target)), target, seconds, log)
    return _library
