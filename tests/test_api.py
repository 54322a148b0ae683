"""Unified loader API: probe order and dispatch.

Mirrors /root/reference/src/root.zig:24-40 (probe PNG -> JPEG -> QOI -> BMP).
"""

import os

import numpy as np
import pytest

import zpix
from zpix.errors import UnknownFormat


def test_dispatch_all_formats(testdata, png_dir):
    png_img = zpix.load(os.path.join(png_dir, "basn2c08.png"))
    assert type(png_img).__name__ == "RGBAImage"

    jpg_img = zpix.load(os.path.join(testdata, "video-001.jpeg"))
    assert type(jpg_img).__name__ == "YCbCrImage"

    bmp_img = zpix.load(os.path.join(testdata, "video-001.bmp"))
    assert bmp_img.width == 150

    # QOI via encode round-trip
    from zpix.codecs import qoi

    rgba = png_img.rgba_pixels()
    data = qoi.encode(rgba, qoi.Desc(png_img.width, png_img.height, 4, 0))
    qoi_img = zpix.from_buffer(data)
    assert np.array_equal(qoi_img.rgba_pixels(), rgba)


def test_unknown_format():
    with pytest.raises(UnknownFormat):
        zpix.from_buffer(b"\x00\x01\x02\x03 definitely not an image")


def test_decode_config(testdata):
    with open(os.path.join(testdata, "video-001.jpeg"), "rb") as f:
        cfg = zpix.decode_config(f.read())
    assert (cfg.width, cfg.height) == (150, 103)


def test_drawer():
    from zpix.image import Drawer, RGBAImage, Rectangle

    img = RGBAImage.init(Rectangle.init(0, 0, 16, 16))
    d = Drawer(img)
    d.clear((1, 2, 3, 4))
    assert tuple(img.pix[8, 8]) == (1, 2, 3, 4)
    d.fill_rect(Rectangle.init(2, 2, 6, 6), (9, 9, 9, 255))
    assert tuple(img.pix[3, 3]) == (9, 9, 9, 255)
    d.draw_line(0, 0, 15, 15, (255, 0, 0, 255))
    assert tuple(img.pix[0, 0]) == (255, 0, 0, 255)
    assert tuple(img.pix[15, 15]) == (255, 0, 0, 255)
    d.draw_circle(8, 8, 5, (0, 255, 0, 255))
    assert tuple(img.pix[8, 13]) == (0, 255, 0, 255)


def test_sub_image():
    """sub_image views the intersection and keeps chroma alignment
    (per-type subImage, image.zig:153-176; YCbCr deep-copy :557-583)."""
    import numpy as np

    import zpix
    from tools import corpus
    from zpix.image import Rectangle

    img = zpix.from_buffer(corpus.png_bytes(corpus.photo(103, 150, 1),
                                            color_type=2, depth=8))
    full = img.rgba_pixels().reshape(img.height, img.width, 4)
    r = Rectangle.init(17, 9, 101, 77)
    sub = img.sub_image(r)
    assert (sub.width, sub.height) == (84, 68)
    got = sub.rgba_pixels().reshape(68, 84, 4)
    assert np.array_equal(got, full[9:77, 17:101])
    # out-of-range rect -> empty image, not an error
    empty = img.sub_image(Rectangle.init(5000, 5000, 6000, 6000))
    assert empty.width == 0 and empty.height == 0

    # YCbCr (odd origin exercises the absolute cOffset alignment)
    jimg = zpix.from_buffer(corpus.read("photo0_plain.jpg"))
    jfull = jimg.rgba_pixels().reshape(jimg.height, jimg.width, 4)
    jsub = jimg.sub_image(Rectangle.init(13, 7, 100, 50))
    jgot = jsub.rgba_pixels().reshape(43, 87, 4)
    assert np.array_equal(jgot, jfull[7:50, 13:100])
    # nested sub of a sub keeps alignment too
    jsub2 = jsub.sub_image(Rectangle.init(20, 10, 60, 40))
    assert np.array_equal(
        jsub2.rgba_pixels().reshape(30, 40, 4), jfull[10:40, 20:60]
    )


def test_at_and_set_pixel():
    """Per-type at() returns the Color.toRGBA premultiplied 16-bit tuple
    (image.zig:54-66); set_pixel writes native channels; out-of-bounds
    reads are the zero color and writes are no-ops, as in Go."""
    import numpy as np

    from zpix.image.geometry import Rectangle
    from zpix.image.model import (
        GrayImage, Gray16Image, NRGBAImage, RGBAImage, YCbCrImage,
    )

    g = GrayImage.init(Rectangle.init(0, 0, 4, 3))
    g.set_pixel(1, 2, 200)
    y16 = 200 * 0x101
    assert g.at(1, 2) == (y16, y16, y16, 0xFFFF)
    assert g.at(-1, 0) == (0, 0, 0, 0)
    g.set_pixel(99, 99, 7)  # silently ignored

    g16 = Gray16Image.init(Rectangle.init(0, 0, 2, 2))
    g16.set_pixel(0, 1, 0x1234)
    assert g16.at(0, 1) == (0x1234, 0x1234, 0x1234, 0xFFFF)

    n = NRGBAImage.init(Rectangle.init(0, 0, 2, 2))
    n.set_pixel(1, 0, (100, 50, 25, 128))
    r, gg, b, a = n.at(1, 0)
    # non-premultiplied -> premultiplied: (c|c<<8)*a/0xff
    assert (r, gg, b) == tuple((c | (c << 8)) * 128 // 0xFF for c in (100, 50, 25))
    assert a == 128 * 0x101

    p = RGBAImage.init(Rectangle.init(0, 0, 2, 2))
    p.set_pixel(0, 0, (9, 8, 7, 255))
    assert p.at(0, 0) == (9 * 0x101, 8 * 0x101, 7 * 0x101, 0xFFFF)

    yc = YCbCrImage.init(Rectangle.init(0, 0, 4, 4), "420")
    yc.y[1, 1] = 90
    assert yc.at(1, 1)[3] == 0xFFFF  # reads work through the plane copy
    import pytest as _pytest

    with _pytest.raises(TypeError):
        yc.set_pixel(0, 0, 1)
