"""Host (C++) libraries of the port, built on first use and bound with
ctypes — the port's own counterpart of the reference's utils/native.py.

``load("bpe_core")`` compiles ``csrc/bpe_core.cc`` with the host C++
compiler, as the reference's native/Makefile does:

    g++ -O2 -std=c++17 -shared -fPIC -o build/lib<name>-<hash>.so csrc/<name>.cc

into ``p2p_llm_chat_tpu_torch/build/`` (git-ignored), named by a hash of
its source and flags, so an edited source is rebuilt and an unchanged one
reused. Loading is fail-soft: with no compiler, or a build that fails,
``load`` returns None and the caller takes its pure-Python path. Nothing
here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

from .log import get_logger

log = get_logger("native")

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"      # shared with ops/_build.py's kernels

CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_cache: dict[str, Optional[ctypes.CDLL]] = {}


def _build(name: str) -> str:
    src = CSRC_DIR / f"{name}.cc"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    if out.exists():
        return str(out)
    cxx = shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise OSError("no C++ compiler (g++ or c++) on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        raise OSError(f"{cxx} failed for {src.name} (exit "
                      f"{proc.returncode}): {proc.stderr.strip()[-500:]}")
    os.replace(tmp, out)
    return str(out)


def load(name: str) -> Optional[ctypes.CDLL]:
    """The library ``csrc/<name>.cc``, built on first use, or None when it
    cannot be built or loaded (the caller falls back to Python). Results,
    failures included, are kept for the process."""
    with _lock:
        if name in _cache:
            return _cache[name]
        lib = None
        try:
            lib = ctypes.CDLL(_build(name))
            log.info("native %s loaded", name)
        except (OSError, subprocess.TimeoutExpired) as e:
            log.info("native %s unavailable (%s); using the pure-Python "
                     "path", name, e)
        _cache[name] = lib
        return lib
