"""The port's native tile loader (``utils/native_loader.py``) against
hygrid_tpu's: raw rasters written by either read back by the other, the
same tiles in the same order from the native library and from the
pure-Python fallback, the same LZW decode; and the port builds its library
into ``build/``, never under ``native/``."""
import hashlib
import subprocess
import sys

import numpy as np
import pytest

from hygrid_tpu.utils import native_loader as jnl
from hygrid_tpu_torch.utils import native_loader as tnl
from hygrid_tpu_torch.image import codecs as tcodecs


@pytest.fixture
def raster(tmp_path):
    arr = np.random.default_rng(0).random((3, 50, 70)).astype(np.float32)
    path = str(tmp_path / "img.hgraw")
    spec = tnl.write_raw_raster(path, arr)
    return arr, path, spec


def test_raw_rasters_cross_packages(tmp_path, raster):
    arr, path, spec = raster
    assert np.array_equal(jnl.read_raw_raster(path, jnl.RawRasterSpec(
        50, 70, 3, np.float32)), arr)
    other = str(tmp_path / "j.hgraw")
    jspec = jnl.write_raw_raster(other, arr[::-1].copy())
    assert np.array_equal(tnl.read_raw_raster(other, tnl.RawRasterSpec(
        jspec.height, jspec.width, jspec.bands, jspec.dtype)), arr[::-1])
    assert (spec.height, spec.width, spec.bands, spec.dtype) == \
        (50, 70, 3, np.dtype(np.float32))


def _tiles(module, path, spec, tile, python):
    if python:
        saved = module._lib, module._lib_tried
        module._lib, module._lib_tried = None, True
    try:
        spec = module.RawRasterSpec(spec.height, spec.width, spec.bands,
                                    spec.dtype)
        with module.NativeTileLoader([path], spec, tile=tile,
                                     threads=3) as loader:
            backend = loader.backend
            tiles = [(t.row0, t.col0, t.valid_rows, t.valid_cols,
                      t.data.copy()) for t in loader.stream_tiles(0, 3)]
    finally:
        if python:
            module._lib, module._lib_tried = saved
    return backend, tiles


@pytest.mark.parametrize("python", [False, True])
def test_tile_streams_match_jax(raster, python):
    arr, path, spec = raster
    backend, got = _tiles(tnl, path, spec, (16, 32), python)
    assert backend == ("python" if python else "native")
    _, want = _tiles(jnl, path, spec, (16, 32), python)
    assert [g[:4] for g in got] == [w[:4] for w in want]
    assert all(np.array_equal(g[4], w[4]) for g, w in zip(got, want))
    recon = np.zeros_like(arr)
    for r0, c0, vr, vc, data in got:
        recon[:, r0:r0 + vr, c0:c0 + vc] = data[:, :vr, :vc]
        assert not data[:, vr:].any() and not data[:, :, vc:].any()
    assert np.array_equal(recon, arr) and len(got) == 4 * 3


def test_ordered_tickets(raster):
    _, path, spec = raster
    with tnl.NativeTileLoader([path], spec, tile=(16, 32),
                              threads=4) as loader:
        coords = [(r, c) for r in (0, 16, 32) for c in (0, 32, 64)]
        assert [loader.enqueue(0, r, c) for r, c in coords] == list(range(9))
        assert [(t.row0, t.col0) for t in
                (loader.next() for _ in coords)] == coords
        with pytest.raises(IndexError):
            loader.next()


def test_lzw_decode_matches_jax():
    rng = np.random.default_rng(5)
    for n in (1, 37, 4096, 60001):
        data = (rng.integers(0, 7, n, dtype=np.uint8) * 31).tobytes()
        enc = tcodecs._lzw_encode(data)
        assert tnl.lzw_decode_native(enc, expect=n) == data
        assert tnl.lzw_decode_native(enc) == data         # growth path
        assert jnl.lzw_decode_native(enc, expect=n) == data


def test_build_goes_to_build_dir_not_native(tmp_path):
    """A fresh process builds the library from native/hygrid_io.cpp into
    the given build directory; nothing under native/ changes."""
    native = tnl.SOURCE.parent

    def snapshot():
        return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
                for p in sorted(native.iterdir()) if p.is_file()}

    before = snapshot()
    code = ("from pathlib import Path\n"
            "from hygrid_tpu_torch.utils import native_loader as nl\n"
            f"nl.BUILD_DIR = Path({str(tmp_path)!r})\n"
            "assert nl.native_available()\n"
            "print(nl.library_path())\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          cwd=str(tnl.SOURCE.parents[1]))
    assert proc.returncode == 0, proc.stderr
    built = proc.stdout.strip()
    assert built.startswith(str(tmp_path)) and built.endswith(".so")
    assert [p.name for p in tmp_path.iterdir()] == [built.split("/")[-1]]
    assert snapshot() == before
