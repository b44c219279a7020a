"""The host replay buffers' native gather (port of
``sheeprl_tpu/native/__init__.py``): ``gather.cpp``, built with g++ and
loaded with ``ctypes``.

The shared library is compiled at first use (``g++ -O3 -shared -fPIC
-std=c++17 -pthread``) into ``sheeprl_tpu_torch/_build/``, named by a hash
of the source so that a changed source is rebuilt, written under a
per-process temporary name and published by an atomic rename (two
processes building at once never load a half-written library).

Unlike the JAX loader, which falls back to numpy when the build fails, a
failed build raises :class:`NativeBuildError` with the compiler's error.
``gather_rows`` and ``gather_sequences`` return None only for an input the
kernel does not take (fewer than two axes, not C-contiguous, an object
dtype or an empty item), as the JAX functions do; the buffers gather those
with numpy, which is also the plain version the tests hold the kernel to.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np

from sheeprl_tpu_torch.ops._build import BUILD_DIR

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "gather.cpp")
DEFAULT_THREADS = min(8, os.cpu_count() or 1)
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
# native gathers of this process: one a gathered array (``gather_rows`` or
# ``gather_sequences``)
launch_count = 0


class NativeBuildError(RuntimeError):
    """g++ is missing or refused ``gather.cpp``."""


def build(src: Optional[str] = None) -> str:
    """Compile ``src`` (``SRC`` by default) unless a build of the same
    source exists; returns the shared library's path."""
    src = src or SRC
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    so_path = os.path.join(BUILD_DIR, f"gather_{digest}.so")
    if os.path.exists(so_path):
        return so_path
    gxx = shutil.which("g++")
    if gxx is None:
        raise NativeBuildError("g++ not found on PATH: the native replay gather (sheeprl_tpu_torch/native/gather.cpp) cannot be built")
    tmp_path = f"{so_path}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run(
            [gxx, "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread", src, "-o", tmp_path],
            capture_output=True,
            text=True,
            timeout=120,
        )
        if proc.returncode != 0:
            raise NativeBuildError(f"g++ failed on {src} (exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp_path, so_path)
    finally:
        if os.path.exists(tmp_path):
            os.remove(tmp_path)
    return so_path


def load() -> ctypes.CDLL:
    """Build (if needed) and load the gather library, once a process."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            i64p = ctypes.POINTER(ctypes.c_int64)
            lib.gather_sequences.restype = ctypes.c_int
            lib.gather_sequences.argtypes = [
                ctypes.c_void_p,  # src
                ctypes.c_int64,  # buffer_size
                ctypes.c_int64,  # n_envs
                ctypes.c_int64,  # item_bytes
                i64p,  # starts
                i64p,  # envs
                ctypes.c_int64,  # batch_dim
                ctypes.c_int64,  # seq_len
                ctypes.c_int64,  # n_samples
                ctypes.c_int64,  # batch
                ctypes.c_int64,  # shift
                ctypes.c_void_p,  # dst
                ctypes.c_int,  # n_threads
            ]
            lib.gather_rows.restype = ctypes.c_int
            lib.gather_rows.argtypes = [
                ctypes.c_void_p,  # src
                ctypes.c_int64,  # buffer_size
                ctypes.c_int64,  # n_envs
                ctypes.c_int64,  # item_bytes
                i64p,  # rows
                i64p,  # envs
                ctypes.c_int64,  # count
                ctypes.c_void_p,  # dst
                ctypes.c_int,  # n_threads
            ]
            _LIB = lib
    return _LIB


def _item_bytes(src: np.ndarray) -> Optional[int]:
    """The bytes of one ``src[row, env]`` item, or None when the kernel does
    not take ``src``."""
    if src.ndim < 2 or not src.flags.c_contiguous or src.dtype.hasobject:
        return None
    item_bytes = int(np.prod(src.shape[2:], dtype=np.int64)) * src.itemsize
    return item_bytes or None


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise ValueError(f"native {what} refused its arguments (rc {rc})")


def gather_sequences(
    src: np.ndarray, starts: np.ndarray, envs: np.ndarray, seq_len: int, n_samples: int, batch: int, shift: int = 0
) -> Optional[np.ndarray]:
    """Ring buffer ``src [size, n_envs, ...]`` → contiguous ``[n_samples,
    seq_len, batch, ...]``, sequence ``s = (n, b)`` reading rows
    ``(starts[s] + shift + t) % size`` of env ``envs[s]``; None when the
    kernel does not take ``src``."""
    item_bytes = _item_bytes(src)
    if item_bytes is None:
        return None
    lib = load()
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    envs = np.ascontiguousarray(envs, dtype=np.int64)
    batch_dim = int(starts.shape[0])
    if batch_dim != n_samples * batch or envs.shape[0] != batch_dim:
        raise ValueError(f"{batch_dim} starts and {envs.shape[0]} envs for {n_samples} x {batch} sequences")
    dst = np.empty((n_samples, seq_len, batch) + src.shape[2:], dtype=src.dtype)
    rc = lib.gather_sequences(
        src.ctypes.data_as(ctypes.c_void_p),
        src.shape[0],
        src.shape[1],
        item_bytes,
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        envs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        batch_dim,
        seq_len,
        n_samples,
        batch,
        shift,
        dst.ctypes.data_as(ctypes.c_void_p),
        DEFAULT_THREADS,
    )
    _check(rc, "gather_sequences")
    global launch_count
    launch_count += 1
    return dst


def gather_rows(src: np.ndarray, rows: np.ndarray, envs: np.ndarray) -> Optional[np.ndarray]:
    """Row gather: ``src [size, n_envs, ...]`` → ``[count, ...]``, row ``i``
    being ``src[rows[i] % size, envs[i]]``; None when the kernel does not
    take ``src``."""
    item_bytes = _item_bytes(src)
    if item_bytes is None:
        return None
    lib = load()
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    envs = np.ascontiguousarray(envs, dtype=np.int64)
    count = int(rows.shape[0])
    if envs.shape[0] != count:
        raise ValueError(f"{count} rows and {envs.shape[0]} envs")
    dst = np.empty((count,) + src.shape[2:], dtype=src.dtype)
    rc = lib.gather_rows(
        src.ctypes.data_as(ctypes.c_void_p),
        src.shape[0],
        src.shape[1],
        item_bytes,
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        envs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        count,
        dst.ctypes.data_as(ctypes.c_void_p),
        DEFAULT_THREADS,
    )
    _check(rc, "gather_rows")
    global launch_count
    launch_count += 1
    return dst
