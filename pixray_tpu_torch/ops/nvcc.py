"""Build a ``csrc/*.cu`` source into a shared library with a plain C interface.

``nvcc -gencode arch=compute_90a,code=sm_90a`` into ``pixray_tpu_torch/_build/``
at first use (rebuilt when the source is newer than the library); the
callers load the result with ``ctypes``.  Nothing here runs at import.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]


def source_path(name: str) -> str:
    return os.path.join(PKG_DIR, "csrc", name)


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, name)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build_library(source: str, library: str, force: bool = False) -> str:
    """Compile ``source`` into ``library`` if it is missing or older than the source."""
    if (not force and os.path.exists(library)
            and os.path.getmtime(library) >= os.path.getmtime(source)):
        return library
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, source]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {source} ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, library)
    return library
