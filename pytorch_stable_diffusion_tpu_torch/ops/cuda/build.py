"""Build a CUDA source of ``csrc/`` into a shared library and load it.

Each kernel source has a plain C interface and is compiled by ``nvcc`` for
Hopper (``sm_90a``) into ``build/kernels/`` at the root of the checkout
(listed in ``.gitignore``) at first use, then loaded with ``ctypes``.  The
library name carries a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header rebuilds.  :func:`load_all` starts one ``nvcc`` per source, all at once.  A
finished build is moved into place atomically, so processes that build at
once do not see a partial file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, Tuple[ctypes.CDLL, str]] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: CUDA kernels are built on a machine "
                           "with the CUDA toolkit (PATH or CUDA_HOME)")
    return path


def library_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a hash of the source, the
    shared headers of ``csrc/`` and the flags."""
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def load(name: str) -> Tuple[ctypes.CDLL, str]:
    """Build ``csrc/<name>.cu`` if needed and load it.

    Returns the library and the build log (nvcc's ``-Xptxas -v`` report of
    registers, shared memory and spills; empty when the library was built
    before).  A library loaded before is returned as it is, unhashed: the
    wrappers call this on every launch."""
    return load_all([name])[name]


def load_all(names: Iterable[str]) -> Dict[str, Tuple[ctypes.CDLL, str]]:
    """:func:`load` for several sources, their ``nvcc`` runs started
    together and all waited for before any failure is raised."""
    names = list(names)
    todo = [name for name in names if name not in _LOADED]
    builds = {}
    for name in todo:
        so = library_path(name)
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True)
        builds[name] = (proc, tmp, so, time.perf_counter())
    logs, failed = {}, []
    for name, (proc, tmp, so, t0) in builds.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{err}")
            continue
        os.replace(tmp, so)
        logs[name] = f"built {so.name} in {time.perf_counter() - t0:.1f} s\n{err}"
    if failed:
        raise RuntimeError("\n".join(failed))
    for name in todo:
        _LOADED[name] = (ctypes.CDLL(str(library_path(name))), logs.get(name, ""))
    return {name: _LOADED[name] for name in names}
