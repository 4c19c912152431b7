"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``)
into one shared library with a plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/hygrid_tpu_torch/libhygrid_<hash>.so csrc/*.cu

The library is built at the first kernel call, from the sources in this
package only, and named by a hash of the sources and flags, so an edited
source is rebuilt and an unchanged one is loaded as it is.  A missing
``nvcc`` or a failed build raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "hygrid_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
# every pointer and the stream are c_void_p: a bare Python int would be
# passed as a 32-bit C int and cut the address
_SIGNATURES = {
    "hg_plan_gather": [_P, _P, _P, _P, _LL, _LL, _LL, _I, _I, _P],
    "hg_hex_conv_layer": [_P, _P, _P, _P, _P, _P, _P, _I, _F, _P, _P, _P, _I,
                          _P, _I, _I, _I, _I, _I, _I, _I, _P, _I, _P],
}

_lock = threading.Lock()
_lib = None
build_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the "
        "hygrid_tpu_torch CUDA kernels cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libhygrid_{digest.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    cu = [str(s) for s in _sources() if s.suffix == ".cu"]
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *cu]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    build_info.update(seconds=time.perf_counter() - t0, command=cmd,
                      log=proc.stdout + proc.stderr)


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            build_info["path"] = str(path)
            _lib = lib
        return _lib


def check(status: int, what: str) -> None:
    """Raise for a non-zero status returned by a C entry point."""
    if status == -1:
        raise ValueError(f"{what}: the kernel refused its arguments")
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")
