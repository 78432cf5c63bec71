"""ctypes bridge to the native safetensors reader (port of
``weights/native_io.py``).

The reader is the repo-root ``csrc/safetensors_reader.cc`` (a memory map
and a header parser with a plain C interface), built with ``g++`` at first
use into ``build/native/`` at the root of the checkout (listed in
``.gitignore``), under a name that carries a hash of the source and the
flags, and loaded with ``ctypes``.  Tensors come back as torch CPU tensors,
BF16 ones as ``torch.bfloat16`` (the bytes viewed, not converted).

There is no second reader: where ``g++`` fails, every read raises
``RuntimeError`` with the compiler's message.  (The JAX package falls back
to the ``safetensors`` package, which the GPU machine does not have.)
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from collections.abc import Mapping
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

REPO_DIR = Path(__file__).resolve().parents[2]
SOURCE = REPO_DIR / "csrc" / "safetensors_reader.cc"
BUILD_DIR = REPO_DIR / "build" / "native"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

#: safetensors dtype -> (numpy dtype of the bytes, torch dtype of the tensor)
DTYPES = {
    "F64": (np.float64, torch.float64), "F32": (np.float32, torch.float32),
    "F16": (np.float16, torch.float16), "BF16": (np.uint16, torch.bfloat16),
    "I64": (np.int64, torch.int64), "I32": (np.int32, torch.int32),
    "I16": (np.int16, torch.int16), "I8": (np.int8, torch.int8),
    "U8": (np.uint8, torch.uint8), "BOOL": (np.bool_, torch.bool),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libsdt_safetensors-{digest.hexdigest()[:16]}.so"


def _build(so: Path) -> Optional[str]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"build failed: {e}"
    if r.returncode != 0:
        return f"g++ failed: {r.stderr[:2000]}"
    os.replace(tmp, so)
    return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        so = library_path()
        if not so.exists():
            _build_error = _build(so)
            if _build_error:
                return None
        lib = ctypes.CDLL(str(so))
        lib.st_open.restype = ctypes.c_void_p
        lib.st_open.argtypes = [ctypes.c_char_p]
        lib.st_error.restype = ctypes.c_char_p
        lib.st_error.argtypes = [ctypes.c_void_p]
        lib.st_num_tensors.restype = ctypes.c_int64
        lib.st_num_tensors.argtypes = [ctypes.c_void_p]
        lib.st_name.restype = ctypes.c_char_p
        lib.st_name.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.st_dtype.restype = ctypes.c_char_p
        lib.st_dtype.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.st_ndim.restype = ctypes.c_int64
        lib.st_ndim.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.st_shape.restype = None
        lib.st_shape.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                 ctypes.POINTER(ctypes.c_int64)]
        lib.st_data.restype = ctypes.c_void_p
        lib.st_data.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                ctypes.POINTER(ctypes.c_uint64)]
        lib.st_close.restype = None
        lib.st_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the reader could not be built (the compiler's message), or None."""
    _load()
    return _build_error


class SafetensorsFile(Mapping):
    """A safetensors file, memory-mapped: ``f[name]`` copies that one tensor
    out of the mapping into a torch CPU tensor, so a caller that walks the
    names one at a time holds one tensor at a time.  Close it (or use it as
    a context manager) to unmap the file."""

    def __init__(self, path: str):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native safetensors reader unavailable: {_build_error}")
        self._lib = lib
        self._h = lib.st_open(str(path).encode())
        err = lib.st_error(self._h)
        if err:
            lib.st_close(self._h)
            self._h = None
            raise ValueError(f"safetensors parse error in {path}: {err.decode()}")
        self._index = {lib.st_name(self._h, i).decode(): i
                       for i in range(lib.st_num_tensors(self._h))}

    def __getitem__(self, name: str) -> torch.Tensor:
        if self._h is None:
            raise ValueError("the safetensors file is closed")
        lib, h, i = self._lib, self._h, self._index[name]
        dt = lib.st_dtype(h, i).decode()
        if dt not in DTYPES:
            raise ValueError(f"unsupported dtype {dt} for {name}")
        np_dtype, torch_dtype = DTYPES[dt]
        ndim = lib.st_ndim(h, i)
        shape = (ctypes.c_int64 * max(ndim, 1))()
        lib.st_shape(h, i, shape)
        shp = tuple(shape[j] for j in range(ndim))
        nbytes = ctypes.c_uint64()
        ptr = lib.st_data(h, i, ctypes.byref(nbytes))
        expect = int(np.prod(shp, dtype=np.int64)) * np.dtype(np_dtype).itemsize
        if expect != nbytes.value:
            raise ValueError(f"{name}: byte length {nbytes.value} != shape {shp} x {dt}")
        if nbytes.value == 0:
            return torch.zeros(shp, dtype=torch_dtype)
        buf = (ctypes.c_char * nbytes.value).from_address(ptr)
        arr = np.frombuffer(buf, dtype=np_dtype).reshape(shp).copy()
        return torch.from_numpy(arr).view(torch_dtype)

    def __iter__(self):
        return iter(self._index)

    def __len__(self):
        return len(self._index)

    def close(self) -> None:
        if self._h is not None:
            self._lib.st_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of ``path`` as a torch CPU tensor."""
    with SafetensorsFile(path) as f:
        return {name: f[name] for name in f}
