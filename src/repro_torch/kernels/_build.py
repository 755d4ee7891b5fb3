"""Build and load the hand-written Hopper kernels.

The CUDA sources in ``csrc/`` are compiled by ``nvcc`` at first use, from
the checkout's own files: every source to an object at once (one ``nvcc``
process each, in parallel), then linked into one ``libmist_kernels.so``
with a plain C interface, loaded with ``ctypes``.  The library goes to
``build/kernels/<hash>/`` at the repository root, keyed by a hash of the
sources, the header they share (``*.cuh``) and the flags: an unchanged
tree loads the built library at once, a changed source or header builds
anew.  A missing ``nvcc`` or a failed build raises;
nothing falls back to the plain versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
LIB_NAME = "libmist_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]
# the CUDA toolkit's default install prefix, tried after CUDA_HOME and PATH
DEFAULT_CUDA_HOME = Path("/usr/local/cuda")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# filled by the build that ran in this process (None when the library was
# already built): wall seconds and the compiler's output, -Xptxas -v included
BUILD_SECONDS: Optional[float] = None
BUILD_LOG: str = ""


def find_nvcc() -> Optional[str]:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = DEFAULT_CUDA_HOME / "bin" / "nvcc"
    return str(default) if default.is_file() else None


def _sources():
    """The sources compiled, one object each."""
    return sorted(CSRC.glob("*.cu"))


def _hashed_files():
    """Every file a build reads: the sources and the headers they include."""
    return sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")])


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _hashed_files():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources into the shared library (if not built yet) and
    return its path."""
    global BUILD_SECONDS, BUILD_LOG
    out_dir = _build_dir()
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (CUDA_HOME, PATH, the toolkit's default prefix): "
            "the Hopper kernels are built from csrc/ at first use and need "
            "the CUDA toolkit")
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    tag = f"{os.getpid()}"
    jobs = []
    for src in _sources():
        obj = out_dir / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        jobs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for src, _, proc in jobs:
        out, _ = proc.communicate()
        logs.append(f"$ nvcc -c {src.name}\n{out}")
        if proc.returncode:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    tmp_lib = out_dir / f"{LIB_NAME}.{tag}"
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
         *[str(obj) for _, obj, _ in jobs]],
        capture_output=True, text=True)
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp_lib, lib)  # atomic: concurrent builders agree on one file
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    BUILD_SECONDS = time.perf_counter() - t0
    BUILD_LOG = "\n".join(logs)
    (out_dir / "build.log").write_text(BUILD_LOG)
    return lib


def _declare(lib: ctypes.CDLL) -> None:
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    lib.mist_flash_attn_fwd.argtypes = (
        [p] * 5 + [i] * 6 + [ll] * 9 + [f, i, i, p])
    lib.mist_flash_attn_fwd.restype = i
    lib.mist_flash_attn_bwd.argtypes = [p] * 10 + [i] * 6 + [f, i, i, p]
    lib.mist_flash_attn_bwd.restype = i
    lib.mist_rmsnorm.argtypes = [p, p, p, i, i, f, i, i, i, p]
    lib.mist_rmsnorm.restype = i
    lib.mist_rmsnorm_bwd.argtypes = [p] * 6 + [i, i, f, i, i, i, i, p]
    lib.mist_rmsnorm_bwd.restype = i
    lib.mist_ssd_scan.argtypes = [p] * 9 + [i] * 8 + [ll] * 12 + [p]
    lib.mist_ssd_scan.restype = i
    lib.mist_ssd_scan_bwd.argtypes = [p] * 16 + [i] * 8 + [ll] * 12 + [p]
    lib.mist_ssd_scan_bwd.restype = i
    lib.mist_ssd_scan_bwd_occupancy.argtypes = [i] * 7 + [p]
    lib.mist_ssd_scan_bwd_occupancy.restype = i
    lib.mist_error_string.argtypes = [i]
    lib.mist_error_string.restype = ctypes.c_char_p


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _declare(lib)
            _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if err:
        msg = _lib.mist_error_string(err).decode() if _lib else ""
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
