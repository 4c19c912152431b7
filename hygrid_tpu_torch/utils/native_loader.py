"""ctypes bindings for the native threaded tile loader
(``native/hygrid_io.cpp``), a copy of ``hygrid_tpu/utils/native_loader.py``
for the PyTorch port.

The library is built on first use with ``g++`` from ``native/hygrid_io.cpp``
into the git-ignored ``build/hygrid_tpu_torch/``, named by a hash of the
source and flags (as ``kernels/_build.py`` names the CUDA library), so an
edited source is rebuilt and nothing is written under ``native/``.  Where
the compiler or the source is missing, a pure-Python threaded fallback
with the same API takes over (host I/O, not a device path).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import queue
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = ["NativeTileLoader", "write_raw_raster", "read_raw_raster",
           "native_available", "RawRasterSpec"]

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "hygrid_io.cpp"
BUILD_DIR = _ROOT / "build" / "hygrid_tpu_torch"
CXX_FLAGS = ["-O2", "-fPIC", "-std=c++17", "-Wall", "-shared", "-pthread"]
_lib = None
_lib_tried = False
_lock = threading.Lock()   # reader threads may ask for the codec at once


def library_path() -> Path:
    """Where the library of the current source and flags is built."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libhygrid_io_{digest.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise OSError("g++ not found")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
    finally:
        if tmp.exists():
            tmp.unlink()


def _load_lib():
    global _lib, _lib_tried
    with _lock:
        if not _lib_tried:
            _lib = _open_lib()
            _lib_tried = True
    return _lib


def _open_lib():
    if not SOURCE.exists():
        return None
    path = library_path()
    try:
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
    except (OSError, subprocess.SubprocessError):
        return None
    lib.hg_loader_create.restype = ctypes.c_void_p
    lib.hg_loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32]
    lib.hg_loader_enqueue.restype = ctypes.c_int64
    lib.hg_loader_enqueue.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                      ctypes.c_int64, ctypes.c_int64]
    lib.hg_loader_next.restype = ctypes.c_int64
    lib.hg_loader_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_int64)]
    lib.hg_loader_destroy.argtypes = [ctypes.c_void_p]
    lib.hg_write_raw.restype = ctypes.c_int32
    lib.hg_write_raw.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                 ctypes.c_int64]
    lib.hg_lzw_decode.restype = ctypes.c_int64
    lib.hg_lzw_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                  ctypes.c_void_p, ctypes.c_int64]
    return lib


def lzw_decode_native(data: bytes, expect: Optional[int] = None
                      ) -> Optional[bytes]:
    """TIFF-LZW decode through the C++ codec (~100x the pure-Python one);
    None when the library is unavailable or the stream is corrupt (the
    caller falls back to the Python twin, which raises a proper error).
    ``expect`` sizes the output buffer when the caller knows the decoded
    length (TIFF chunk geometry); otherwise the buffer grows on demand."""
    lib = _load_lib()
    if lib is None:
        return None
    cap = (expect + 64) if expect else max(4 * len(data), 1 << 16)
    while True:
        dst = ctypes.create_string_buffer(cap)
        n = lib.hg_lzw_decode(data, len(data), dst, cap)
        if n >= 0:
            return dst.raw[:n]
        if n == -1 and cap < 1 << 31:       # undersized output buffer
            cap *= 2
            continue
        return None                          # corrupt stream


def native_available() -> bool:
    return _load_lib() is not None


class RawRasterSpec:
    """Band-sequential raw raster: (C, H, W) elements of one dtype."""

    def __init__(self, height: int, width: int, bands: int, dtype=np.float32):
        self.height, self.width, self.bands = height, width, bands
        self.dtype = np.dtype(dtype)


def write_raw_raster(path: str, array: np.ndarray) -> RawRasterSpec:
    """Write (C, H, W) as a .hgraw band-sequential file."""
    array = np.ascontiguousarray(array)
    lib = _load_lib()
    if lib is not None:
        buf = array.tobytes()
        rc = lib.hg_write_raw(path.encode(), buf, len(buf))
        if rc != 0:
            raise OSError(f"native write failed for {path}")
    else:
        array.tofile(path)
    return RawRasterSpec(array.shape[1], array.shape[2], array.shape[0],
                         array.dtype)


def read_raw_raster(path: str, spec: RawRasterSpec) -> np.ndarray:
    a = np.fromfile(path, dtype=spec.dtype)
    return a.reshape(spec.bands, spec.height, spec.width)


class NativeTileLoader:
    """Prefetching tile loader over band-sequential raw rasters.

    Usage::

        loader = NativeTileLoader(paths, spec, tile=(512, 512), threads=4)
        for t in loader.stream_tiles(file_idx=0):   # prefetch-ahead iterator
            ...  # t.data (C, tr, tc), t.row0/col0, t.valid

    Falls back to a Python thread pool when the native library is missing
    (``loader.backend`` tells which is active).
    """

    class Tile:
        __slots__ = ("data", "file_idx", "row0", "col0", "valid_rows",
                     "valid_cols")

    def __init__(self, paths: Sequence[str], spec: RawRasterSpec,
                 tile: Tuple[int, int] = (2000, 2000), threads: int = 4,
                 depth: int = 8):
        self.paths = list(paths)
        self.spec = spec
        self.tr, self.tc = tile
        lib = _load_lib()
        self._handle = None
        self._py = None
        if lib is not None:
            arr = (ctypes.c_char_p * len(self.paths))(
                *[p.encode() for p in self.paths])
            self._handle = lib.hg_loader_create(
                arr, len(self.paths), spec.height, spec.width, spec.bands,
                spec.dtype.itemsize, self.tr, self.tc, threads, depth)
            self._lib = lib
            if not self._handle:
                raise OSError("native loader failed to open rasters")
            self.backend = "native"
        else:
            self._py = _PyLoader(self.paths, spec, (self.tr, self.tc),
                                 threads)
            self.backend = "python"

    def enqueue(self, file_idx: int, row0: int, col0: int) -> int:
        if self._handle:
            t = self._lib.hg_loader_enqueue(self._handle, file_idx, row0, col0)
            if t < 0:
                raise ValueError("bad enqueue")
            return int(t)
        return self._py.enqueue(file_idx, row0, col0)

    def next(self) -> "NativeTileLoader.Tile":
        t = NativeTileLoader.Tile()
        if self._handle:
            buf = np.empty((self.spec.bands, self.tr, self.tc),
                           self.spec.dtype)
            meta = (ctypes.c_int64 * 4)()
            ticket = self._lib.hg_loader_next(
                self._handle, buf.ctypes.data_as(ctypes.c_void_p), meta)
            if ticket < 0:
                raise IndexError("no outstanding tiles")
            t.data = buf
            t.file_idx, t.row0, t.col0 = int(meta[0]), int(meta[1]), int(meta[2])
            t.valid_rows = int(meta[3]) >> 32
            t.valid_cols = int(meta[3]) & 0xFFFFFFFF
            return t
        return self._py.next()

    def stream_tiles(self, file_idx: int = 0, ahead: int = 4):
        """Iterate every tile of a raster with ``ahead`` tiles prefetched."""
        coords = [(r, c)
                  for r in range(0, self.spec.height, self.tr)
                  for c in range(0, self.spec.width, self.tc)]
        it = iter(coords)
        outstanding = 0
        for _ in range(min(ahead, len(coords))):
            r, c = next(it)
            self.enqueue(file_idx, r, c)
            outstanding += 1
        while outstanding:
            tile = self.next()
            outstanding -= 1
            nxt = next(it, None)
            if nxt is not None:
                self.enqueue(file_idx, *nxt)
                outstanding += 1
            yield tile

    def close(self):
        if self._handle:
            self._lib.hg_loader_destroy(self._handle)
            self._handle = None
        if self._py:
            self._py.close()
            self._py = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _PyLoader:
    """Pure-Python fallback with the same ordered-ticket semantics."""

    def __init__(self, paths, spec, tile, threads):
        self.paths, self.spec = paths, spec
        self.tr, self.tc = tile
        self._work: "queue.Queue" = queue.Queue()
        self._done = {}
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._next_ticket = 0
        self._next_out = 0
        self._stop = False
        self._threads = [threading.Thread(target=self._worker, daemon=True)
                         for _ in range(max(1, threads))]
        for t in self._threads:
            t.start()

    def _worker(self):
        while True:
            item = self._work.get()
            if item is None:
                return
            ticket, fi, r0, c0 = item
            spec = self.spec
            tile = NativeTileLoader.Tile()
            data = np.zeros((spec.bands, self.tr, self.tc), spec.dtype)
            vr = max(0, min(self.tr, spec.height - r0))
            vc = max(0, min(self.tc, spec.width - c0))
            mm = np.memmap(self.paths[fi], dtype=spec.dtype, mode="r",
                           shape=(spec.bands, spec.height, spec.width))
            data[:, :vr, :vc] = mm[:, r0:r0 + vr, c0:c0 + vc]
            tile.data, tile.file_idx = data, fi
            tile.row0, tile.col0 = r0, c0
            tile.valid_rows, tile.valid_cols = vr, vc
            with self._cv:
                self._done[ticket] = tile
                self._cv.notify_all()

    def enqueue(self, fi, r0, c0):
        with self._lock:
            ticket = self._next_ticket
            self._next_ticket += 1
        self._work.put((ticket, fi, r0, c0))
        return ticket

    def next(self):
        with self._cv:
            want = self._next_out
            if want >= self._next_ticket:
                raise IndexError("no outstanding tiles")
            while want not in self._done:
                self._cv.wait()
            tile = self._done.pop(want)
            self._next_out += 1
            return tile

    def close(self):
        for _ in self._threads:
            self._work.put(None)
