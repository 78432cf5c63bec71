"""Torch-free (and exploit-free) reader for torch-format .ckpt files (a
copy of the JAX package's ``weights/ckpt_reader.py``).

The module is carried over rather than imported (importing any module of
the JAX package imports jax).  Below this docstring it is the original
line for line, but for ``_bf16``: the original views BF16 storages through
``ml_dtypes``, which comes with jax; the copy reads them as raw ``uint16``
(no other storage type here is unsigned 16-bit), and
``weights/convert.load_state_dict`` views those arrays as
``torch.bfloat16``.  tests/test_torch_import.py holds the copy to the
original.

The original's notes follow.  The reference loads the CompVis checkpoint
with ``torch.load(weights_only=False)`` (``sd/model_converter.py:5``) — a
full pickle execution, which both requires torch at load time and will
happily run arbitrary code embedded in a malicious checkpoint.  This module
parses the torch zip format directly with a *restricted* unpickler:

  * only the handful of constructors a tensor checkpoint legitimately needs
    are resolvable (OrderedDict, _rebuild_tensor_v2, storage dtype tags);
    anything else — including the classic ``os.system`` reduce payload —
    raises immediately;
  * storages are materialized as numpy arrays straight from the zip entries
    (``archive/data/<key>``), honoring storage offset / shape / strides.

Covers the modern zip-based serialization torch has used since 1.6 (every
SD checkpoint in circulation).  Legacy tar-format pickles are rejected.
"""

from __future__ import annotations

import io
import pickle
import zipfile
from collections import OrderedDict
from typing import Any, Dict

import numpy as np

class LegacyCkptError(ValueError):
    """Raised when the file is not a torch zip-format checkpoint at all
    (legacy tar-format pickle, or some other container).  This — and only
    this — is the error class callers may treat as "try another loader";
    security refusals (``pickle.UnpicklingError``) must never be."""


_DTYPES = {
    "FloatStorage": np.float32,
    "DoubleStorage": np.float64,
    "HalfStorage": np.float16,
    "LongStorage": np.int64,
    "IntStorage": np.int32,
    "ShortStorage": np.int16,
    "CharStorage": np.int8,
    "ByteStorage": np.uint8,
    "BoolStorage": np.bool_,
}


def _bf16():
    return np.dtype(np.uint16)  # raw bf16 bits: no storage type here is uint16


class _StorageTag:
    def __init__(self, name):
        self.name = name


class _StorageRef:
    def __init__(self, dtype, key, numel):
        self.dtype = dtype
        self.key = key
        self.numel = numel


def _make_rebuild(reader):
    def _rebuild_tensor_v2(storage, storage_offset, size, stride,
                           requires_grad=False, backward_hooks=None,
                           metadata=None):
        return reader._materialize(storage, storage_offset, tuple(size),
                                   tuple(stride))

    return _rebuild_tensor_v2


class _RestrictedUnpickler(pickle.Unpickler):
    def __init__(self, f, reader):
        super().__init__(f)
        self._reader = reader

    def find_class(self, module, name):
        if (module, name) == ("collections", "OrderedDict"):
            return OrderedDict
        if module == "torch._utils" and name in ("_rebuild_tensor_v2",
                                                 "_rebuild_tensor"):
            return _make_rebuild(self._reader)
        if module == "torch" and name in _DTYPES:
            return _StorageTag(name)
        if (module, name) == ("torch", "BFloat16Storage"):
            return _StorageTag(name)
        raise pickle.UnpicklingError(
            f"refusing to unpickle {module}.{name} (not a tensor constructor)")

    def persistent_load(self, pid):
        # ('storage', StorageTag, key, location, numel)
        if not (isinstance(pid, tuple) and len(pid) >= 5 and pid[0] == "storage"):
            raise pickle.UnpicklingError(f"unexpected persistent id: {pid!r}")
        _, tag, key, _location, numel = pid[:5]
        name = tag.name if isinstance(tag, _StorageTag) else str(tag)
        dtype = _bf16() if name == "BFloat16Storage" else _DTYPES.get(name)
        if dtype is None:
            raise pickle.UnpicklingError(f"unsupported storage type {name}")
        return _StorageRef(np.dtype(dtype), str(key), int(numel))


class _CkptReader:
    def __init__(self, zf: zipfile.ZipFile):
        self._zf = zf
        names = zf.namelist()
        pkls = [n for n in names if n.endswith("/data.pkl") or n == "data.pkl"]
        if not pkls:
            raise LegacyCkptError(
                "not a torch zip checkpoint (no data.pkl) — "
                "legacy tar-format .ckpt files are not supported")
        self._pkl = pkls[0]
        self._prefix = self._pkl[: -len("data.pkl")]
        self._cache: Dict[str, np.ndarray] = {}

    def _storage_bytes(self, key: str) -> np.ndarray:
        if key not in self._cache:
            self._cache[key] = np.frombuffer(
                self._zf.read(f"{self._prefix}data/{key}"), np.uint8)
        return self._cache[key]

    def _materialize(self, ref: _StorageRef, offset: int, size, stride):
        raw = self._storage_bytes(ref.key)
        flat = raw.view(ref.dtype)
        total = int(flat.shape[0])
        offset = int(offset)
        # Bounds validation BEFORE any as_strided: offset/size/stride come
        # from the (untrusted) pickle stream, and an out-of-range view would
        # read past the storage buffer (heap disclosure / segfault).
        if offset < 0 or any(int(s) < 0 for s in size) \
                or any(int(st) < 0 for st in stride):
            raise ValueError(
                f"storage {ref.key}: negative offset/size/stride "
                f"({offset}, {size}, {stride})")
        if not size:  # 0-d tensor -> 0-d ndarray (not a numpy scalar)
            if offset >= total:
                raise ValueError(f"storage {ref.key}: scalar offset {offset} "
                                 f"out of bounds (storage has {total} elems)")
            return flat[offset: offset + 1].reshape(()).copy()
        n = int(np.prod(size))
        if n == 0:
            return np.zeros(size, ref.dtype)
        last = offset + sum((int(s) - 1) * int(st)
                            for s, st in zip(size, stride))
        if last >= total:
            raise ValueError(
                f"storage {ref.key}: tensor extent out of bounds — offset "
                f"{offset}, shape {tuple(size)}, strides {tuple(stride)} "
                f"address element {last} of a {total}-element storage")
        itemsize = ref.dtype.itemsize
        contig = []
        acc = 1
        for s in reversed(size):
            contig.append(acc)
            acc *= s
        contig = tuple(reversed(contig))
        if tuple(stride) == contig:
            return flat[offset: offset + n].reshape(size).copy()
        arr = np.lib.stride_tricks.as_strided(
            flat[offset:], shape=size,
            strides=tuple(st * itemsize for st in stride))
        return np.ascontiguousarray(arr)

    def load(self) -> Any:
        up = _RestrictedUnpickler(io.BytesIO(self._zf.read(self._pkl)), self)
        return up.load()


def load_torch_object(path: str) -> Any:
    """Read a torch zip-format pickle and return the raw object tree
    (nested dicts/lists with numpy leaves) — used for non-state-dict
    artifacts like textual-inversion embeddings
    ({"string_to_param": {"*": tensor}}).  Same restricted unpickler, same
    safety guarantees."""
    with zipfile.ZipFile(path) as zf:
        return _CkptReader(zf).load()


def load_torch_ckpt(path: str) -> Dict[str, np.ndarray]:
    """Read a torch zip-format checkpoint without torch.

    Returns the ``state_dict`` mapping (unwrapped if nested) with numpy
    values; non-tensor entries (ints, etc.) are dropped.
    """
    with zipfile.ZipFile(path) as zf:
        obj = _CkptReader(zf).load()
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    if not isinstance(obj, dict):
        raise ValueError(f"checkpoint root is {type(obj)}, expected a dict")
    return {k: v for k, v in obj.items() if isinstance(v, np.ndarray)}
