"""Build the hand-written CUDA kernels on first use and bind them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface, so ``nvcc`` builds it in
seconds (no PyTorch headers):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/lib<name>-<hash>.so csrc/<name>.cu

The library lands in ``p2p_llm_chat_tpu_torch/build/`` (git-ignored), named
by a hash of its source and flags so an edited kernel is rebuilt and an
unchanged one is reused. Nothing here runs at import: importing the package
never needs ``nvcc``. Every C entry point returns ``cudaGetLastError()``;
:func:`check` raises on a non-zero code, so a refused launch (too many
threads, too much shared memory) is never silent.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
KERNELS = ("quant_mm", "paged_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
_locks = {name: threading.Lock() for name in KERNELS}
# ptxas resource report (registers, shared memory, spills) per kernel
# source, kept from the build that produced the loaded library.
build_logs: dict[str, str] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH or CUDA_HOME): the CUDA "
                       "kernels cannot be built on this machine")


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library of the same source and
    flags is already built. Safe to call from several threads at once
    (each source has its own lock; the output is renamed into place)."""
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src.name} "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    build_logs[name] = proc.stderr
    os.replace(tmp, out)
    return out


def load(name: str, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The bound library for kernel source ``name``, built on first use.
    ``bind`` sets argtypes/restype (every pointer and the stream as
    ``c_void_p`` — without it ctypes passes a 32-bit int and cuts the
    pointer)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _locks[name]:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            bind(lib)
            _libs[name] = lib
    return lib


def check(rc: int, lib: ctypes.CDLL, error_string: str, what: str) -> None:
    if rc != 0:
        fn = getattr(lib, error_string)
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{what}: CUDA error {rc} "
                           f"({fn(rc).decode(errors='replace')})")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
