"""Build and load the CUDA kernels of the port.

Each source in ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``.  No PyTorch headers
are involved, so a build takes seconds.  The library goes into ``build/`` at
the repository root (listed in ``.gitignore``), named by a hash of its source,
flags and ``-D`` defines, so an edited source is rebuilt and a stale library
is never loaded; nvcc's output (the ptxas register and spill lines) is kept
beside it.  The build happens at first use, never at import, and builds of
different sources may run in parallel threads.
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

_CSRC = Path(__file__).resolve().parent / "csrc"
_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = _ROOT / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# the C functions of each source: name -> (argtypes, restype)
_C_API = {
    "sketch_step": {
        "sketch_step_launch": ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                ctypes.c_void_p], ctypes.c_int),
        "cuda_error_string": ([ctypes.c_int], ctypes.c_char_p)},
    "l2_chase": {
        "l2_chase_launch": ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                             ctypes.c_void_p], ctypes.c_int)},
}

_lock = threading.Lock()
_libs: dict[tuple, ctypes.CDLL] = {}
# per (source, defines): {"seconds": build time, "log": nvcc's output}
build_info: dict[tuple, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: building the CUDA kernels needs "
                           "the CUDA toolkit (on PATH or /usr/local/cuda)")
    return found


def build(name: str = "sketch_step", defines: tuple[str, ...] = ()) -> Path:
    """Compile ``csrc/<name>.cu`` (with ``-D`` each of ``defines``) into
    ``build/`` unless already built; fills ``build_info[(name, defines)]``."""
    src = _CSRC / f"{name}.cu"
    flags = NVCC_FLAGS + [f"-D{d}" for d in defines]
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(flags).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}_{digest}.so"
    log = out.with_suffix(".log")
    if out.exists():
        build_info[(name, defines)] = {
            "seconds": 0.0,
            "log": log.read_text() if log.exists() else ""}
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *flags, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src.name} {defines}:\n"
                           f"{proc.stdout}{proc.stderr}")
    log.write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)              # atomic: concurrent builders agree
    build_info[(name, defines)] = {"seconds": time.perf_counter() - t0,
                                   "log": proc.stdout + proc.stderr}
    return out


def load_library(name: str = "sketch_step",
                 defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    key = (name, tuple(defines))
    with _lock:
        if key in _libs:
            return _libs[key]
    lib = ctypes.CDLL(str(build(name, key[1])))
    for fn, (argtypes, restype) in _C_API[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    with _lock:
        return _libs.setdefault(key, lib)
