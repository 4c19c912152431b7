"""The port's raster layer (``image/``) against hygrid_tpu's.

Files cross between the packages in both directions: a PNG, a GeoTIFF and
N-band TIFFs (LZW, Deflate, PackBits, tiled, BigTIFF) written by either
``codecs`` read back by the other as equal arrays, geotransforms and
projections (GeoKey sets included), and a ``.heximg`` written by either
``HEXIMAGE`` loads in the other with equal attributes.  ``IMAGE`` and
``HEXIMAGE`` keep the reference's attributes, windowed reads and tiles;
``ConvertToHexagon`` and the type-1 / type-2 packings are bit-equal to
the reference's.
"""
import pickle

import numpy as np
import pytest

from hygrid_tpu.image import HEXIMAGE as JHEX, IMAGE as JIMAGE
from hygrid_tpu.image import codecs as jcodecs
from hygrid_tpu_torch.image import HEXIMAGE, IMAGE
from hygrid_tpu_torch.image import codecs as tcodecs

PACKAGES = {"jax": jcodecs, "torch": tcodecs}
DIRECTIONS = [("jax", "torch"), ("torch", "jax")]
GEO = (500000.0, 10.0, 0.0, 4600020.0, 0.0, -10.0)


@pytest.fixture
def rgb(tmp_path):
    rng = np.random.default_rng(0)
    arr = (rng.random((3, 40, 36)) * 255).astype(np.uint8)
    path = str(tmp_path / "img.png")
    tcodecs.write_raster(path, arr)
    return arr, path


def _same_geo(a, b):
    assert (a is None) == (b is None)
    if a is not None:
        assert np.allclose(a, b, rtol=0, atol=1e-9)


# (file name, array dtype and shape, write_raster keywords)
RASTERS = [
    ("rgb.png", np.uint8, (3, 20, 24), {}),
    ("geo.tif", np.uint8, (3, 16, 16), dict(geotrans=GEO,
                                            proj="EPSG:32633")),
    ("s2.tif", np.uint16, (4, 33, 29), dict(geotrans=GEO, proj="EPSG:32633",
                                             compress="none")),
    ("lzw.tif", np.uint16, (6, 40, 35), dict(compress="lzw", tile=16,
                                              proj="EPSG:4326")),
    ("deflate.tif", np.float32, (2, 21, 19), dict(compress="deflate",
                                                   geotrans=GEO)),
    ("pack.tif", np.uint8, (5, 18, 30), dict(compress="packbits")),
    ("big.tif", np.int16, (3, 17, 23), dict(compress="lzw", bigtiff=True,
                                             proj="WGS 84 / UTM zone 33N")),
]


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
@pytest.mark.parametrize("name,dtype,shape,kw", RASTERS,
                         ids=[r[0] for r in RASTERS])
def test_rasters_cross_packages(tmp_path, writer, reader, name, dtype,
                                shape, kw):
    rng = np.random.default_rng(len(name))
    arr = (rng.random(shape) * 200).astype(dtype)
    path = str(tmp_path / name)
    PACKAGES[writer].write_raster(path, arr, **kw)
    got, geo, proj = PACKAGES[reader].read_raster(path)
    want, wgeo, wproj = PACKAGES[writer].read_raster(path)
    assert got.dtype == want.dtype and np.array_equal(got, arr)
    _same_geo(geo, wgeo)
    assert proj == wproj
    if "geotrans" in kw:
        _same_geo(geo, kw["geotrans"])
    if "proj" in kw:
        assert proj == kw["proj"]
        assert dict(proj.geokeys) == dict(wproj.geokeys)


def test_custom_crs_geokeys_cross_packages(tmp_path):
    keys = {1024: 1, 1025: 1, 3072: 32767, 3073: "custom TM",
            3082: 500000.0, 3083: 0.0, 3088: 15.0, 3092: 0.9996}
    arr = np.arange(2 * 8 * 8, dtype=np.uint16).reshape(2, 8, 8)
    p1, p2 = str(tmp_path / "a.tif"), str(tmp_path / "b.tif")
    jcodecs.write_raster(p1, arr, GEO, jcodecs.CRS("custom TM", keys))
    _, _, proj = tcodecs.read_raster(p1)
    assert isinstance(proj, tcodecs.CRS) and dict(proj.geokeys) == keys
    tcodecs.write_raster(p2, arr, GEO, proj)
    _, _, back = jcodecs.read_raster(p2)
    assert back == "custom TM" and dict(back.geokeys) == keys
    # a CRS pickles as a plain str: nothing of either package in a pickle
    blob = pickle.dumps(proj)
    assert b"hygrid" not in blob and type(pickle.loads(blob)) is str


def test_lzw_and_packbits_codecs_match_jax():
    rng = np.random.default_rng(5)
    data = (rng.integers(0, 7, 5000, dtype=np.uint8) * 31).tobytes()
    enc = tcodecs._lzw_encode(data)
    assert enc == jcodecs._lzw_encode(data)
    assert tcodecs._lzw_decode(enc) == data
    assert tcodecs._tiff_decompress(enc, 5, len(data)) == data
    pb = tcodecs._packbits_encode(data)
    assert pb == jcodecs._packbits_encode(data)
    assert tcodecs._packbits_decode(pb) == data


class TestIMAGE:
    def test_attributes_match_jax(self, rgb):
        arr, path = rgb
        im, ref = IMAGE(path, device="cpu"), JIMAGE(path)
        for name in ("shape", "height", "width", "bands", "geotrans",
                     "proj", "path", "backend", "filetype"):
            assert getattr(im, name) == getattr(ref, name), name
        assert np.array_equal(im.Image, arr) and im.size(0) == 3

    def test_guards(self):
        with pytest.raises(ValueError):
            IMAGE()
        with pytest.raises(ValueError):
            IMAGE(pathname="x.png", data=np.ones((3, 4, 4)))
        with pytest.raises(OSError):
            IMAGE("/nonexistent/file.png")

    def test_load_window_and_tiles(self, tmp_path):
        rng = np.random.default_rng(7)
        arr = (rng.random((3, 70, 90)) * 255).astype(np.uint8)
        path = str(tmp_path / "t.tif")
        tcodecs.write_raster(path, arr, compress="lzw", tile=32,
                             geotrans=GEO, proj="EPSG:32633")
        im, ref = IMAGE(path, lazy=True), JIMAGE(path, lazy=True)
        assert im.Image is None and im.proj == ref.proj == "EPSG:32633"
        win = im.LoadImageArray(5, 3, 60, 50)
        assert np.array_equal(win, ref.LoadImageArray(5, 3, 60, 50))
        assert (im.width, im.height) == (ref.width, ref.height) == (55, 47)
        tiles = list(IMAGE(path, lazy=True).Tiles(tile=40))
        want = list(JIMAGE(path, lazy=True).Tiles(tile=40))
        assert [t[:2] for t in tiles] == [t[:2] for t in want]
        assert all(np.array_equal(a[2], b[2]) for a, b in zip(tiles, want))

    @pytest.mark.parametrize("interp", ["nearest", "bilinear"])
    def test_convert_to_hexagon_matches_jax(self, rgb, interp):
        _, path = rgb
        got = IMAGE(path, device="cpu").ConvertToHexagon(interp)
        want = np.asarray(JIMAGE(path).ConvertToHexagon(interp))
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        assert np.array_equal(got, want)

    def test_save_image_matches_jax(self, tmp_path):
        data = np.random.default_rng(8).random((3, 12, 10)) * 300
        IMAGE(data=data, device="cpu").SaveImage(str(tmp_path / "a.png"))
        JIMAGE(data=data).SaveImage(str(tmp_path / "b.png"))
        a = tcodecs.read_raster(str(tmp_path / "a.png"))[0]
        assert np.array_equal(a, jcodecs.read_raster(
            str(tmp_path / "b.png"))[0])


class TestHEXIMAGE:
    def test_hexify_on_load_matches_jax(self, rgb):
        _, path = rgb
        him, ref = HEXIMAGE(path, device="cpu"), JHEX(path)
        assert him.shape == ref.shape == (3, 20, 18)
        assert np.array_equal(him.HexagonImage, np.asarray(ref.HexagonImage))

    @pytest.mark.parametrize("offset", [0, 1])
    def test_type_packings_match_jax(self, offset):
        rng = np.random.default_rng(9)
        data = (rng.random((3, 7, 6)) * 255).astype(np.float64)
        him = HEXIMAGE(data=data, even_odd_offset=offset, device="cpu")
        ref = JHEX(data=data, even_odd_offset=offset)
        for fn in ("GenerateType1Image", "GenerateType2Image"):
            (got, g1), (want, g2) = getattr(him, fn)(), getattr(ref, fn)()
            want = np.asarray(want)
            assert got.dtype == want.dtype and np.array_equal(got, want)
            assert g1 == g2

    @pytest.mark.parametrize("imagetype", [1, 2])
    @pytest.mark.parametrize("writer,reader", DIRECTIONS)
    def test_packed_files_cross_packages(self, rgb, tmp_path, imagetype,
                                         writer, reader):
        _, path = rgb
        made = {"jax": JHEX(path), "torch": HEXIMAGE(path, device="cpu")}
        out = str(tmp_path / f"t{imagetype}.png")
        made[writer].SaveHexImage(out, imagetype=imagetype)
        back = (HEXIMAGE(out, heximagetype=imagetype, device="cpu")
                if reader == "torch" else JHEX(out, heximagetype=imagetype))
        assert back.shape == made[writer].shape
        assert np.array_equal(back.HexagonImage,
                              np.asarray(made[writer].HexagonImage))

    @pytest.mark.parametrize("writer,reader", DIRECTIONS)
    def test_heximg_cross_packages(self, tmp_path, writer, reader):
        rng = np.random.default_rng(10)
        data = (rng.random((4, 9, 11)) * 4000).astype(np.uint16)
        kw = dict(data=data, geotrans=GEO, even_odd_offset=1)
        made = {"jax": lambda: JHEX(proj=jcodecs.CRS("EPSG:32633",
                                                     {3072: 32633}), **kw),
                "torch": lambda: HEXIMAGE(proj=tcodecs.CRS(
                    "EPSG:32633", {3072: 32633}), device="cpu", **kw)}
        src = made[writer]()
        out = str(tmp_path / "x.heximg")
        src.SaveHexImage(out)
        with open(out, "rb") as f:
            assert b"hygrid" not in f.read()
        back = (HEXIMAGE(out, device="cpu") if reader == "torch"
                else JHEX(out))
        assert np.array_equal(back.HexagonImage, data)
        assert back.HexagonImage.dtype == data.dtype
        for name in ("shape", "geotrans", "proj", "even_odd_offset",
                     "filetype"):
            assert getattr(back, name) == getattr(
                JHEX(out) if reader == "torch" else HEXIMAGE(
                    out, device="cpu"), name), name
        assert back.proj == "EPSG:32633" and back.even_odd_offset == 1

    def test_from_data_variants_and_hex_imshow(self, tmp_path):
        rng = np.random.default_rng(11)
        t1 = (rng.random((2, 6, 13)) * 255).astype(np.float32)
        a = HEXIMAGE(data=t1, heximagetype=1, device="cpu")
        assert np.array_equal(a.HexagonImage, JHEX(
            data=t1, heximagetype=1).HexagonImage)
        hexi = (rng.random((3, 12, 12)) * 255).astype(np.float32)
        him = HEXIMAGE(data=hexi, device="cpu")
        out = str(tmp_path / "m.png")
        frame = him.Hex_imshow(out_size=(96, 96), save_to=out)
        want = JHEX(data=hexi).Hex_imshow(out_size=(96, 96))
        assert frame.dtype == np.uint8 and np.array_equal(frame, want)
        assert np.array_equal(tcodecs.read_raster(out)[0], frame)
