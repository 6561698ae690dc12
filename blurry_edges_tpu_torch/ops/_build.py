"""Build the CUDA kernels under ``csrc/`` into one shared library with a
plain C interface, at first use, and load it with ctypes.

Each ``.cu`` source is compiled by its own ``nvcc`` process, all started
together, then linked into ``_build/libkernels_<hash>.so``. The hash covers
the sources, the headers and the flags, so an edited source rebuilds. Needs
``nvcc`` (on PATH, under $CUDA_HOME, or /usr/local/cuda); no PyTorch
headers, no ninja.

The JPEG decoder (``csrc/jpeg_decode.cu``, host code over nvJPEG) is built
apart, at the first JPEG decode, into ``_build/libimage_<hash>.so``, linked
with the toolkit's ``libnvjpeg``: the kernels' library does not depend on
it.
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
           "flash_attn_bwd_dkv.cu", "flash_attn_bwd_dq.cu", "local_epilogue.cu")
HEADERS = ("wedge_common.cuh", "async_copy.cuh", "flash_mma.cuh")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-Xptxas=-v")

IMAGE_SOURCES = ("jpeg_decode.cu",)

_P, _I, _F, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_double
_SIGNATURES = {
    "wedge_colors_launch": [_P, _P, _P, _I, _I, _F, _F, _P],
    "wedge_colors_smem_bytes": [_I],
    "wedge_render_launch": [_P] * 9 + [_I, _I, _I, _F, _F, _I] + [_F] * 8 + [_P],
    "wedge_render_smem_bytes": [_I],
    "flash_attn_fwd_launch": [_P] * 5 + [_I, _I, _F, _P],
    "flash_attn_bwd_dkv_launch": [_P] * 8 + [_I, _I, _F, _P],
    "flash_attn_bwd_dq_launch": [_P] * 7 + [_I, _I, _F, _P],
    "local_epilogue_launch": [_P] * 6 + [_D] + [_P] * 6 + [_D, _P, ctypes.c_longlong]
                             + [_I] * 8 + [_P],
}
_IMAGE_SIGNATURES = {
    "jpeg_info": [ctypes.c_char_p, ctypes.c_size_t, _I] + [ctypes.POINTER(_I)] * 3,
    "jpeg_decode": [ctypes.c_char_p, ctypes.c_size_t, _I, _I, _P, _P, _P, ctypes.POINTER(_I),
                    _P],
}


class Library:
    """The loaded kernels, with how they were built."""

    def __init__(self, cdll: ctypes.CDLL, path: Path, build_seconds: float,
                 log: str, signatures: dict = _SIGNATURES):
        self.cdll = cdll
        self.path = path
        self.build_seconds = build_seconds  # 0.0 when the library was cached
        self.log = log                      # nvcc/ptxas output of the build that made it
        for name, argtypes in signatures.items():
            fn = getattr(cdll, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int


_library = None
_image_library = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _digest(names) -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in names:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _compile(target: Path, sources, link_flags=()) -> str:
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for name in sources:
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
             "-o", str(so), *link_flags], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(so, target)  # atomic: a reader never sees half a library
    return "\n".join(log)


def sass(path: Path) -> str:
    """The SASS of a built library, by the ``cuobjdump`` beside ``nvcc``."""
    tool = Path(_nvcc()).parent / "cuobjdump"
    return subprocess.run([str(tool), "-sass", str(path)], capture_output=True, text=True,
                          timeout=300, check=True).stdout


def _build(stem: str, sources, headers, link_flags, signatures) -> Library:
    target = BUILD_DIR / f"{stem}_{_digest(sources + headers)}.so"
    log_file = target.with_suffix(".log")
    t0 = time.perf_counter()
    if target.exists() and log_file.exists():
        log, seconds = log_file.read_text(), 0.0
    else:
        log = _compile(target, sources, link_flags)
        seconds = time.perf_counter() - t0
        log_file.write_text(log)
    return Library(ctypes.CDLL(str(target)), target, seconds, log, signatures)


def load_library() -> Library:
    """The kernels' library, built on the first call of the process (or
    found in ``_build/`` from an earlier build of the same sources)."""
    global _library
    if _library is None:
        _library = _build("libkernels", SOURCES, HEADERS, (), _SIGNATURES)
    return _library


def load_image_library() -> Library:
    """The nvJPEG decoder's library, built on the first JPEG decode of the
    process. Raises if the toolkit lacks ``nvjpeg.h`` or ``libnvjpeg``."""
    global _image_library
    if _image_library is None:
        home = Path(_nvcc()).resolve().parent.parent       # the toolkit's root
        libdirs = [d for d in (home / "lib64", home / "lib", home / "targets" / "x86_64-linux" / "lib")
                   if any(d.glob("libnvjpeg.so*"))]
        if not (home / "include" / "nvjpeg.h").exists() or not libdirs:
            raise RuntimeError(f"the CUDA toolkit at {home} has no nvjpeg.h or libnvjpeg.so: "
                               f"JPEG decoding on the card needs nvJPEG")
        _image_library = _build("libimage", IMAGE_SOURCES, (),
                                (f"-L{libdirs[0]}", "-lnvjpeg", "-Xlinker", f"-rpath,{libdirs[0]}"),
                                _IMAGE_SIGNATURES)
    return _image_library
