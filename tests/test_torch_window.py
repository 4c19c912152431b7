"""The port's windowed TIFF reader (``image/window.py``) against
hygrid_tpu's: the same tags, shapes, dtypes, windows, tiles and decode
counts (one decode thread) on files the reference writes (classic and
BigTIFF, strips and tiles, every compression the writer makes), and the
same refusals."""
import numpy as np
import pytest

from hygrid_tpu.image import codecs as jcodecs
from hygrid_tpu.image.window import TiffWindowReader as JReader
from hygrid_tpu_torch.image.window import TiffWindowReader, parse_tiff_tags

WINDOWS = [(0, 0, 1, 1), (7, 9, 64, 64), (100, 150, 50, 53), (63, 63, 2, 2),
           (0, 190, 150, 13)]


@pytest.mark.parametrize("compress,tile,dtype,bigtiff", [
    ("lzw", 64, np.uint8, False), ("deflate", None, np.uint16, False),
    ("packbits", 32, np.int16, True), ("none", 128, np.float32, True)])
def test_windows_match_jax(tmp_path, compress, tile, dtype, bigtiff):
    rng = np.random.default_rng(3)
    arr = (rng.random((4, 150, 203)) * 200).astype(dtype)
    p = str(tmp_path / "a.tif")
    jcodecs._write_tiff_nband(p, arr, geotrans=(10.0, 0.5, 0, 20.0, 0, -0.5),
                              proj="EPSG:32633", compress=compress,
                              tile=tile, bigtiff=bigtiff)
    with TiffWindowReader(p) as rd, JReader(p) as ref:
        assert rd.tags == ref.tags and rd.byteorder == ref.byteorder
        assert rd.shape == ref.shape == arr.shape
        assert rd.dtype == ref.dtype == arr.dtype
        assert rd.geotrans == ref.geotrans and rd.proj == ref.proj
        assert np.array_equal(rd.read_all(), arr)
        for r0, c0, h, w in WINDOWS:
            got = rd.read_window(r0, c0, h, w)
            assert np.array_equal(got, ref.read_window(r0, c0, h, w))
    with open(p, "rb") as f:
        assert parse_tiff_tags(f)[0] == ref.tags


def test_tiles_and_bounded_cache_match_jax(tmp_path):
    arr = np.random.default_rng(0).integers(0, 255, (3, 300, 260),
                                            dtype=np.uint8)
    p = str(tmp_path / "b.tif")
    jcodecs._write_tiff_nband(p, arr, compress="deflate", tile=64)
    cap = 4 * 64 * 64
    with TiffWindowReader(p, cache_bytes=cap) as rd, \
            JReader(p, cache_bytes=cap) as ref:
        tiles = list(rd.iter_tiles(100))
        want = list(ref.iter_tiles(100))
        assert [t[:2] for t in tiles] == [t[:2] for t in want]
        assert all(np.array_equal(a[2], b[2]) for a, b in zip(tiles, want))
        assert rd._cache_bytes <= cap


def test_decodes_only_intersecting_chunks_as_jax(tmp_path):
    arr = np.arange(6 * 256 * 256, dtype=np.uint16).reshape(6, 256, 256)
    p = str(tmp_path / "t.tif")
    jcodecs._write_tiff_nband(p, arr, compress="lzw", tile=64)
    with TiffWindowReader(p) as rd, JReader(p) as ref:
        for window, decoded in (((10, 10, 20, 20), 6), ((12, 12, 10, 10), 6),
                                ((60, 60, 10, 10), 24)):
            got = rd.read_window(*window, threads=1)
            assert np.array_equal(got, ref.read_window(*window, threads=1))
            assert rd.chunks_decoded == ref.chunks_decoded == decoded


def test_window_refusals_match_jax(tmp_path):
    p = str(tmp_path / "e.tif")
    jcodecs._write_tiff_nband(p, np.zeros((1, 40, 40), np.uint8))
    with TiffWindowReader(p) as rd:
        for bad in [(-1, 0, 4, 4), (0, 0, 41, 4), (38, 0, 4, 4),
                    (0, 0, 0, 4)]:
            with pytest.raises(ValueError):
                rd.read_window(*bad)
    q = str(tmp_path / "not.tif")
    with open(q, "wb") as f:
        f.write(b"PK\x03\x04" + b"\0" * 16)
    with pytest.raises(ValueError):
        TiffWindowReader(q)
