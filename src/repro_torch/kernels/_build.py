"""Build and load the CUDA kernels of the port.

Each source in ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``.  No PyTorch headers
are involved, so a build takes seconds.  The library goes into ``build/`` at
the repository root (listed in ``.gitignore``), named by a hash of its source,
the headers in ``csrc/``, the flags and ``-D`` defines, so an edited source
or header is rebuilt and a stale library is never loaded; nvcc's output (the
ptxas register and spill lines) is kept beside it.  The build happens at
first use, never at import, and builds of different sources may run in
parallel threads.  ``launch`` calls a kernel's C launch function on the
current CUDA stream and raises on a CUDA error.
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

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = _ROOT / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ERR = {"cuda_error_string": ([_I], ctypes.c_char_p)}
# the C functions of each source: name -> (argtypes, restype); the stream
# is the last argument of every launch function
_C_API = {
    "sketch_step": {
        "sketch_step_launch": ([_P, _I, _P], _I), **_ERR},   # args, threads
    "sketch_update": {      # counters, dk, lo, hi, b, rows, width,
        "sketch_update_launch":                 # cap, dk_bits, dk_probes
            ([_P] * 4 + [_I] * 6 + [_P], _I), **_ERR},
    "sketch_estimate": {    # counters, dk, lo, hi, out, b, rows, width,
        "sketch_estimate_launch":               # dk_bits, dk_probes
            ([_P] * 5 + [_I] * 5 + [_P], _I), **_ERR},
    "admission": {          # counters, dk, clo, chi, vlo, vhi, out, b,
        "admission_launch":                     # rows, width, dk_bits, dkp,
            ([_P] * 7 + [_I] * 6 + [_P], _I), **_ERR},     # per_thread
    "sketch_reset": {       # counters, n_counter_words, dk, n_dk_words
        "sketch_reset_launch": ([_P, _I, _P, _I, _P], _I), **_ERR},
    "flash_attention": {    # q, k, v, out, kv_len or NULL; B, Sq, Skv,
        "flash_attention_launch":   # Hq, Hkv, D; k and v's (b, s, h) strides;
            ([_P] * 5 + [_I] * 15      # causal, q_offset, kv_len default;
             + [_F, _F, _P], _I),       # softcap, scale
        "flash_attention_train_launch":     # q, k, v, out, lse; B, S, Hq,
            ([_P] * 5 + [_I] * 5 + [_F, _F, _P], _I),  # Hkv, D; softcap,
        **_ERR},                                       # scale
    "flash_attention_bwd": {    # q, k, v, o, dO, lse, work, counters,
        "flash_attention_bwd_launch":   # dq, dk, dv; B, S, Hq, Hkv, D;
            ([_P] * 11 + [_I] * 5 + [_F, _F, _P], _I), **_ERR},  # softcap,
                                                                 # scale
    "l2_chase": {
        "l2_chase_launch": ([_P, _I, _P, _P], _I)},
    "sketch_baseline": {    # first designs: as reset, estimate, admit
        "baseline_reset_launch": ([_P, _I, _P, _I, _P], _I),
        "baseline_estimate_launch": ([_P] * 5 + [_I] * 5 + [_P], _I),
        "baseline_admission_launch": ([_P] * 7 + [_I] * 6 + [_P], _I),
        **_ERR},
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


def _info_key(name: str, defines: tuple, csrc: Path | None) -> tuple:
    return (name, defines) if csrc is None else (name, defines, str(csrc))


def build(name: str = "sketch_step", defines: tuple[str, ...] = (),
          csrc: Path | None = None) -> Path:
    """Compile ``csrc/<name>.cu`` (with ``-D`` each of ``defines``) into
    ``build/`` unless already built; fills ``build_info[(name, defines)]``.
    ``csrc`` names another directory of sources and headers (an A/B
    comparison's other copy); its info key gains the directory."""
    src_dir = _CSRC if csrc is None else Path(csrc)
    info = _info_key(name, defines, csrc)
    src = src_dir / f"{name}.cu"
    flags = NVCC_FLAGS + [f"-D{d}" for d in defines]
    headers = b"".join(h.read_bytes() for h in sorted(src_dir.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(flags).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}_{digest}.so"
    log = out.with_suffix(".log")
    if out.exists():
        build_info[info] = {
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
    build_info[info] = {"seconds": time.perf_counter() - t0,
                                   "log": proc.stdout + proc.stderr}
    return out


def load_library(name: str = "sketch_step", defines: tuple[str, ...] = (),
                 csrc: Path | None = None) -> ctypes.CDLL:
    """The loaded kernel library, built on first use (from ``csrc``, as
    :func:`build` takes it)."""
    key = _info_key(name, tuple(defines), csrc)
    with _lock:
        if key in _libs:
            return _libs[key]
    lib = ctypes.CDLL(str(build(name, key[1], csrc)))
    for fn, (argtypes, restype) in _C_API[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    with _lock:
        return _libs.setdefault(key, lib)


def launch(name: str, fn: str, *args, lib: ctypes.CDLL | None = None) -> None:
    """Call the launch function ``fn`` of ``csrc/<name>.cu`` (of ``lib``,
    default the plain build) on the current CUDA stream: tensors pass as
    pointers, floats as C floats, other numbers as C ints (or pointers, as
    ``_C_API`` declares).  Raises
    ValueError if a tensor is not a contiguous CUDA tensor (checked before
    anything is built) and RuntimeError on a non-zero CUDA error."""
    ptrs = []
    stream_dev = None
    for a in args:
        if isinstance(a, torch.Tensor):
            if not (a.is_cuda and a.is_contiguous()):
                raise ValueError(f"{name}: kernel operands must be "
                                 "contiguous CUDA tensors")
            ptrs.append(a.data_ptr())
            stream_dev = stream_dev or a.device
        else:
            ptrs.append(a if isinstance(a, float) else int(a))
    lib = lib or load_library(name)
    check_error(name, lib, getattr(lib, fn)(
        *ptrs, torch.cuda.current_stream(stream_dev).cuda_stream))


def check_error(name: str, lib: ctypes.CDLL, err: int) -> None:
    """Raise on the non-zero CUDA error a launch function returned."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({lib.cuda_error_string(err).decode()})")
