"""The port's offscreen viewer shell (``viz/pixelart.py``) against
hygrid_tpu's: ``Texture`` pads and expands as the reference does, and
``Window.render_texture`` is bit-equal to the reference's frame through
every view change (the textures hold 8-bit values, which the mosaic's
bfloat16 sampling keeps exactly, on both sides).  ``Window.serve`` runs
on port 0 on a daemon thread, every request under a 10 s timeout and the
whole exchange under a 60 s limit."""
import signal
import urllib.request
from contextlib import contextmanager

import numpy as np
import pytest

from hygrid_tpu.viz import pixelart as jpix
from hygrid_tpu_torch.image import codecs
from hygrid_tpu_torch.viz import Texture, Window


@contextmanager
def time_limit(seconds):
    def expire(*_):
        raise TimeoutError(f"over {seconds} s")
    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def _texture_array(shape, seed=0):
    return np.floor(np.random.default_rng(seed).random(shape) * 256)


@pytest.mark.parametrize("shape", [(1, 10, 10), (3, 13, 18), (4, 8, 9)])
def test_texture_matches_jax(shape):
    arr = _texture_array(shape)
    tex, ref = Texture(imgarr=arr), jpix.Texture(imgarr=arr)
    assert tex.TexSize() == ref.TexSize()
    assert np.array_equal(tex.img, ref.img)
    assert (tex.hierarchy, tex.img_serial_number) == (0, 1)


def test_render_texture_matches_jax_through_view_changes():
    arr = _texture_array((3, 24, 28), seed=1)
    tex, ref_tex = Texture(imgarr=arr), jpix.Texture(imgarr=arr)
    win, ref = Window(96, 80, "t", device="cpu"), jpix.Window(96, 80, "t")
    steps = [None, ("key_event", "w"), ("key_event", "scroll_up"),
             ("drag", (10, 10), (30, 4)), ("key_event", "+"),
             ("zoom", 0.7), ("WindowResize", 120, 72)]
    for step in steps:
        if step is not None:
            getattr(win, step[0])(*step[1:])
            getattr(ref, step[0])(*step[1:])
        got, want = win.render_texture(tex), ref.render_texture(ref_tex)
        assert got.dtype == np.uint8 and got.shape == (3, win.height,
                                                       win.width)
        assert np.array_equal(got, want), step
    frames = win.loop(lambda: win.render_texture(tex), n_frames=2)
    assert len(frames) == 2 and np.array_equal(frames[0], frames[1])
    with pytest.raises(ValueError):
        win.key_event("f13")


def test_step_image_switches_texture(tmp_path):
    files = []
    for i in range(3):
        p = str(tmp_path / f"{i}.png")
        codecs.write_raster(p, np.full((3, 8, 8), 40 * i + 10, np.uint8))
        files.append(p)
    tex = Texture(imgPath=files[0])
    tex.img_serial_number = 0
    win = Window(32, 32, device="cpu")
    win.key_event("pgdn")
    assert win.step_image(tex, files) and tex.img_serial_number == 1
    assert tex.img.max() == 50
    win.key_event("pgup")
    win.key_event("pgup")            # a pending delta is set, not summed
    assert win.step_image(tex, files) and tex.img_serial_number == 0
    assert tex.img.max() == 10 and not win.step_image(tex, files)
    win.key_event("pgup")            # wraps around the list
    assert win.step_image(tex, files) and tex.img_serial_number == 2


def test_serve_stream_and_events():
    tex = Texture(imgarr=_texture_array((3, 24, 24), seed=2))
    win = Window(64, 64, device="cpu")
    with time_limit(60):
        srv = win.serve(tex, port=0, block=False)
        try:
            base = f"http://127.0.0.1:{srv.server_port}"

            def get(path):
                return urllib.request.urlopen(base + path, timeout=10)

            assert b"/stream" in get("/").read()
            f1 = get("/frame").read()
            assert f1[:2] == b"\xff\xd8"                  # a JPEG
            for q in ("key=scroll_up", "key=w", "drag=10,10,20,14",
                      "key=nope"):
                assert get("/event?" + q).read() == b"ok"
            assert win.view.scale != 1.0 and win.view.dy != 0
            assert get("/frame").read() != f1             # the view moved
            stream = get("/stream")
            head = stream.read(200)
            assert b"--hgframe" in head and b"image/jpeg" in head
            stream.close()
        finally:
            srv.shutdown()
            srv.server_close()
