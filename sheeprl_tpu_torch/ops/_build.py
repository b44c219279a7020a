"""Build and load the port's CUDA kernels (counterpart of
``sheeprl_tpu/native/__init__.py``, which g++-compiles the host gather).

Each ``csrc/<name>.cu`` is compiled at first use with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, cached under
``sheeprl_tpu_torch/_build/`` next to a hash of its source, and loaded with
``ctypes``. Nothing here includes PyTorch's headers, so a build takes seconds.
A failed build raises with nvcc's own error text: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
# per kernel source: what ptxas printed about registers and shared memory
PTXAS_REPORT: Dict[str, str] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise KernelBuildError("nvcc not found on PATH or under CUDA_HOME; the CUDA kernels cannot be built")


def nvcc_command(name: str, out_path: str, nvcc: str = "nvcc") -> List[str]:
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    return [
        nvcc,
        *ARCH_FLAGS,
        "-std=c++17",
        "-O3",
        "-shared",
        "-Xcompiler",
        "-fPIC",
        "-Xptxas",
        "-v",
        "-o",
        out_path,
        src,
    ]


def _source_digest(name: str) -> str:
    with open(os.path.join(CSRC_DIR, f"{name}.cu"), "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()[:16]


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless a build of the same source exists;
    returns the path of the shared library."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    so_path = os.path.join(BUILD_DIR, f"{name}_{_source_digest(name)}.so")
    if os.path.exists(so_path):
        PTXAS_REPORT.setdefault(name, "(cached build)")
        return so_path
    nvcc = find_nvcc()
    # a per-process temporary name, published by rename: two processes that
    # build at once never load a half-written library
    tmp_path = f"{so_path}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run(nvcc_command(name, tmp_path, nvcc), capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise KernelBuildError(f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp_path, so_path)
    finally:
        if os.path.exists(tmp_path):
            os.remove(tmp_path)
    PTXAS_REPORT[name] = proc.stderr.strip()
    return so_path


def load(name: str, declare) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; ``declare(lib)`` sets
    the ``argtypes``/``restype`` of its C functions once."""
    lib: Optional[ctypes.CDLL] = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        if name not in _LIBS:
            lib = ctypes.CDLL(build(name))
            declare(lib)
            _LIBS[name] = lib
        return _LIBS[name]
