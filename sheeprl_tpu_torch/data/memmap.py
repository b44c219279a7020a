"""Disk-backed numpy arrays for host replay (port of
``sheeprl_tpu/data/memmap.py::MemmapArray``).

A ``MemmapArray`` is an ``np.memmap`` with one owner per file:

- the instance that owns the file unlinks it when it is collected;
- ``from_array`` over the owner's own file moves the ownership to the new
  instance;
- pickling drops the mapping and the ownership, so a copy unpickled in
  another process never deletes the owner's file; the copy maps the file
  again on first use;
- assignment through ``array`` checks shape and dtype.

It works wherever numpy expects an array (``__array__``, indexing and the
operator mixin).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Optional, Tuple

import numpy as np

ALLOWED_MODES = ("r+", "w+", "c", "copyonwrite", "readwrite", "write")


class MemmapArray(np.lib.mixins.NDArrayOperatorsMixin):
    def __init__(
        self,
        shape: Tuple[int, ...],
        dtype: Any = np.float32,
        mode: str = "r+",
        filename: str | os.PathLike = "./memmap_array.bin",
    ) -> None:
        if mode not in ALLOWED_MODES:
            raise ValueError(f"Accepted values for mode are {ALLOWED_MODES}, got {mode!r}")
        self._filename = Path(filename).resolve()
        self._dtype = np.dtype(dtype)
        self._shape = tuple(int(s) for s in shape)
        self._mode = mode
        self._filename.parent.mkdir(parents=True, exist_ok=True)
        # "r+" needs the file to exist at its size: a new file is created
        create_mode = mode if self._filename.exists() and mode != "w+" else "w+"
        self._array: Optional[np.memmap] = np.memmap(self._filename, dtype=self._dtype, mode=create_mode, shape=self._shape)
        self._has_ownership = True

    @property
    def filename(self) -> Path:
        return self._filename

    @property
    def dtype(self) -> np.dtype:
        return self._dtype

    @property
    def mode(self) -> str:
        return self._mode

    @property
    def shape(self) -> Tuple[int, ...]:
        return self._shape

    @property
    def has_ownership(self) -> bool:
        return self._has_ownership

    @has_ownership.setter
    def has_ownership(self, value: bool) -> None:
        self._has_ownership = bool(value)

    @property
    def array(self) -> np.memmap:
        if self._array is None:
            # mapped again after unpickling; never "w+", which would truncate
            # a file another instance owns
            mode = "r+" if self._mode in ("w+", "write") else self._mode
            self._array = np.memmap(self._filename, dtype=self._dtype, mode=mode, shape=self._shape)
        return self._array

    @array.setter
    def array(self, v: np.ndarray) -> None:
        if not isinstance(v, np.ndarray):
            raise ValueError(f"The value to be set must be an instance of 'np.ndarray', got {type(v)}")
        if isinstance(v, np.memmap):
            # point at the other memmap's file without taking its ownership
            if v.shape != self._shape or v.dtype != self._dtype:
                raise ValueError(f"memmap shape/dtype mismatch: have {self._shape}/{self._dtype}, got {v.shape}/{v.dtype}")
            if Path(v.filename).resolve() != self._filename:
                self._close()
                self._filename = Path(v.filename).resolve()
                self._has_ownership = False
            mode = "r+" if self._mode in ("w+", "write") else self._mode
            self._array = np.memmap(self._filename, dtype=self._dtype, mode=mode, shape=self._shape)
        else:
            if v.shape != self._shape:
                raise ValueError(f"shape mismatch: memmap has {self._shape}, value has {v.shape}")
            self.array[:] = v.astype(self._dtype, copy=False)

    @classmethod
    def from_array(
        cls, array: "np.ndarray | MemmapArray", mode: str = "r+", filename: str | os.PathLike = "./memmap_array.bin"
    ) -> "MemmapArray":
        """A MemmapArray holding a copy of ``array``; over ``array``'s own
        file it takes the file (and its ownership) without copying."""
        src = array.array if isinstance(array, MemmapArray) else array
        if isinstance(array, MemmapArray) and Path(array.filename) == Path(filename).resolve():
            out = cls(shape=src.shape, dtype=src.dtype, mode="r+", filename=filename)
            out._mode = mode
            array.has_ownership = False
        else:
            out = cls(shape=src.shape, dtype=src.dtype, mode=mode, filename=filename)
            out.array[:] = src
            out.array.flush()
        return out

    def _close(self) -> None:
        if self._array is not None:
            self._array.flush()
            del self._array
            self._array = None

    def __del__(self) -> None:
        try:
            owns = self._has_ownership
        except AttributeError:  # construction failed
            return
        try:
            self._close()
            if owns:
                self._filename.unlink(missing_ok=True)
        except Exception:
            # at interpreter shutdown numpy or pathlib may be gone already
            pass

    def __getstate__(self) -> dict:
        state = self.__dict__.copy()
        state["_array"] = None
        state["_has_ownership"] = False
        return state

    def __setstate__(self, state: dict) -> None:
        # a pickled memmap holds only its file's name: without the file
        # there is no data to restore, and an empty array would be a lie
        filename = Path(state["_filename"])
        if not filename.is_file():
            raise FileNotFoundError(
                f"a memory-mapped array of this checkpoint keeps its data in {filename}, which no longer exists: "
                "a checkpoint of a memmapped replay buffer restores only while its files are on disk "
                "(resume with buffer.checkpoint=False to start with an empty buffer instead)"
            )
        self.__dict__.update(state)

    def __array__(self, dtype: Any = None, copy: Any = None) -> np.ndarray:
        arr = self.array
        return arr.astype(dtype) if dtype is not None else arr

    def __getattr__(self, attr: str) -> Any:
        if attr.startswith("_"):
            raise AttributeError(attr)
        return getattr(self.array, attr)

    def __getitem__(self, idx: Any) -> np.ndarray:
        return self.array[idx]

    def __setitem__(self, idx: Any, value: Any) -> None:
        self.array[idx] = value

    def __len__(self) -> int:
        return self._shape[0]

    def __repr__(self) -> str:
        return f"MemmapArray(shape={self._shape}, dtype={self._dtype}, file={self._filename})"
