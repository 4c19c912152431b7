"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for Hopper
(``sm_90a``), all at once, and the objects are linked into one shared
library with a plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -Xptxas -v -c -o <name>.o csrc/<name>.cu   # each, in parallel
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \\
         -o build/hygrid_tpu_torch/libhygrid_<hash>.so *.o

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
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "hygrid_tpu_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_ULL = ctypes.c_ulonglong
_F = ctypes.c_float
# every pointer and the stream are c_void_p: a bare Python int would be
# passed as a 32-bit C int and cut the address
_SIGNATURES = {
    "hg_plan_gather": [_P, _P, _I, _LL, _P, _P],
    "hg_plan_gather_last_launch": [_P],
    "hg_hex_conv_layer": [_P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _F, _P, _P,
                          _P, _LL, _P, _I, _I, _I, _I, _I, _I, _I, _P, _I, _P],
    "hg_gn_relu_backward": [_P, _P, _P, _P, _I, _P, _P, _P, _LL, _P, _P, _I,
                            _I, _LL, _I, _I, _I, _F, _P, _P],
    "hg_gn_backward_device": [_P],
    "hg_hex_conv_wgrad": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _I,
                          _I, _P, _P],
    "hg_shift_resample": [_P, _P, _P, _P, _P, _I, _P, _P, _I, _LL, _I, _I,
                          _I, _I, _I, _I, _I, _P],
    "hg_hex_conv_fused_stack": [_P, _P, _P, _P, _P, _P, _ULL, _ULL, _I, _I,
                                _I, _I, _I, _I, _I, _I, _P, _P, _P],
    "hg_hex_conv_single": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                           _P, _P],
    "hg_hex_max_pool": [_P, _P, _P, _I, _LL, _I, _I, _I, _I, _I, _I, _I, _I,
                        _I, _P],
    "hg_hex_max_pool_backward": [_P, _P, _P, _I, _LL, _I, _I, _I, _I, _I, _I,
                                 _I, _I, _I, _P],
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


def _run_all(cmds):
    """Run the commands in parallel; raise with the output of the first
    that fails.  Returns their combined output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    for cmd, proc, log in zip(cmds, procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{log}")
    return "".join(logs)


def _build(out: Path) -> None:
    nvcc = _nvcc()
    cu = [s for s in _sources() if s.suffix == ".cu"]
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out.parent) as objdir:
        objs = [str(Path(objdir) / f"{s.stem}.o") for s in cu]
        compile_cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(s)]
                        for s, o in zip(cu, objs)]
        link_cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *objs]
        log = _run_all(compile_cmds) + _run_all([link_cmd])
    os.replace(tmp, out)
    build_info.update(seconds=time.perf_counter() - t0,
                      command=[*compile_cmds, link_cmd], log=log)


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
    if status == -2:
        raise RuntimeError(f"{what}: the device cannot run the cooperative "
                           "launch")
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")
