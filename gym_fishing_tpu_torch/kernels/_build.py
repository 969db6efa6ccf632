"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface (``extern "C"`` launchers that
return ``cudaGetLastError()``) and includes no PyTorch header, so one nvcc call
builds it in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o _build/<name>_<hash>.so csrc/<name>.cu

The library is named after a hash of the source, every shared header
(``csrc/*.cuh``) and the flags, so an edit to any of them rebuilds on first
use. A source that fixes its switches when it is compiled is built once per
configuration: `defines` (``-D`` flags) are part of the name. Nothing is
built or loaded at import time: `load` is called by a kernel wrapper the
first time it is given a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence, Tuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills per kernel
)

# loaded libraries: {source name: {defines: library}}
_LIBS: Dict[str, Dict[Tuple[str, ...], ctypes.CDLL]] = {}
# nvcc's output (the ptxas resource report) per library built or found built,
# under its file name and, for the one loaded last, under its source's name
build_log: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str, defines: Sequence[str] = ()) -> Path:
    """Where the library of ``csrc/<name>.cu`` under the macros `defines`
    (``NAME=value`` each) is built, named after a hash of that source, every
    ``csrc/*.cuh`` and the nvcc flags."""
    h = hashlib.sha256()
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    h.update(" ".join([*NVCC_FLAGS, *(f"-D{d}" for d in defines)]).encode())
    return BUILD_DIR / f"{name}_{h.hexdigest()[:16]}.so"


def load(name: str, defines: Sequence[str] = ()) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` with ``-D`` for each of `defines` if its
    library is missing, then load it."""
    defines = tuple(defines)
    lib = _LIBS.get(name, {}).get(defines)
    if lib is not None:
        return lib
    so = library_path(name, defines)
    if not so.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_log[name] = build_log[so.name] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed with code {proc.returncode}:\n{' '.join(cmd)}\n{build_log[name]}"
            )
        so.with_suffix(".log").write_text(build_log[name])  # for a process that finds it built
        os.replace(tmp, so)  # atomic: a concurrent process never loads a partial file
    elif so.name not in build_log and so.with_suffix(".log").exists():
        build_log[name] = build_log[so.name] = so.with_suffix(".log").read_text()
    lib = ctypes.CDLL(str(so))
    _LIBS.setdefault(name, {})[defines] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code (every source exports
    ``cuda_error_string``)."""
    if err != 0:
        lib.cuda_error_string.restype = ctypes.c_char_p
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{what}: CUDA error {err}: {lib.cuda_error_string(err).decode()}")
