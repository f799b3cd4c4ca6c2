"""Builds the CUDA sources in ``csrc/`` at first use and loads them.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface (``nvcc -shared``, no PyTorch headers, so a build takes seconds),
bound through ``ctypes`` by ``kernels.ops``.  All missing libraries are
built together, one ``nvcc`` per source running in parallel.  Libraries are
named by a digest of their sources and flags and land in
``build/repro_torch_kernels/`` at the root of the checkout (git-ignored), so
an unchanged source is compiled once per checkout.  Nothing here runs at
import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("paged_attn", "flash_attention", "stream_mac_conv", "stream_maxpool",
           "tiled_matmul", "ssd_scan", "paged_gather", "stream_gd")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return build_dir() / f"{name}-{_digest(name)}.so"


def build(names=SOURCES) -> dict[str, str]:
    """Compile every library in ``names`` that is not built yet, all at
    once.  Returns each newly built source's compiler output (the
    ``-Xptxas -v`` register and shared-memory report); raises with the
    compiler's output if any build fails."""
    todo = [n for n in names if not library_path(n).is_file()]
    if not todo:
        return {}
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = {}
    for name in todo:
        tmp = out_dir / f"{name}.{os.getpid()}.{threading.get_ident()}.tmp.so"
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building every missing
    library first."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build()
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
            lib.rt_error_string.argtypes = [ctypes.c_int]
            lib.rt_error_string.restype = ctypes.c_char_p
        return lib


def error_string(lib: ctypes.CDLL, code: int) -> str:
    return f"CUDA error {code}: {lib.rt_error_string(code).decode()}"
