"""QOI round-trip and spec-vector tests.

The reference ships no QOI tests (a gap SURVEY.md flags); we use the
encode->decode involution over real decoded images (the reference's
convert-tool path, /root/reference/example/convert.zig:17-86) plus
hand-built op-stream vectors.
"""

import os
import struct

import numpy as np
import pytest

from zpix.codecs import png, qoi
from zpix.errors import FormatError

IMAGES = ["basn2c08", "basn6a08", "basn3p08", "basn0g08"]


@pytest.mark.parametrize("name", IMAGES)
def test_roundtrip_via_png(png_dir, name):
    img = png.load(os.path.join(png_dir, f"{name}.png"))
    rgba = img.rgba_pixels()
    desc = qoi.Desc(img.width, img.height, 4, 0)
    encoded = qoi.encode(rgba, desc)
    decoded = qoi.decode(encoded)
    assert np.array_equal(decoded.rgba_pixels(), rgba)


def test_roundtrip_random():
    rng = np.random.default_rng(42)
    for w, h in [(1, 1), (3, 5), (64, 64), (17, 31)]:
        pix = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
        # Add runs and repeats to exercise RUN/INDEX ops
        pix[::3] = pix[0]
        enc = qoi.encode(pix.reshape(-1), qoi.Desc(w, h, 4, 0))
        dec = qoi.decode(enc)
        assert np.array_equal(dec.pix, pix)


def test_rgb_channels_roundtrip():
    rng = np.random.default_rng(7)
    w, h = 19, 11
    rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    enc = qoi.encode(rgb.reshape(-1), qoi.Desc(w, h, 3, 0))
    dec = qoi.decode(enc)
    assert np.array_equal(dec.pix[..., :3], rgb)
    assert (dec.pix[..., 3] == 255).all()


def test_known_vector():
    """One red pixel: header + OP_RGB + padding."""
    data = (
        struct.pack(">IIIBB", 0x716F6966, 1, 1, 4, 0)
        + bytes([0xFE, 255, 0, 0])
        + bytes([0, 0, 0, 0, 0, 0, 0, 1])
    )
    img = qoi.decode(data)
    assert tuple(img.pix[0, 0]) == (255, 0, 0, 255)


def test_run_op():
    """OP_RUN repeats the previous pixel."""
    data = (
        struct.pack(">IIIBB", 0x716F6966, 4, 1, 4, 0)
        + bytes([0xFE, 9, 8, 7])  # px = (9,8,7,255)
        + bytes([0xC0 | 2])  # run of 3
        + bytes([0, 0, 0, 0, 0, 0, 0, 1])
    )
    img = qoi.decode(data)
    assert [tuple(p) for p in img.pix[0]] == [(9, 8, 7, 255)] * 4


def test_bad_header():
    with pytest.raises(FormatError):
        qoi.decode(b"nope" + b"\x00" * 30)
    with pytest.raises(FormatError):
        qoi.decode(struct.pack(">IIIBB", 0x716F6966, 0, 1, 4, 0) + b"\x00" * 8)


def test_encode_validation():
    with pytest.raises(FormatError):
        qoi.encode(np.zeros(4, np.uint8), qoi.Desc(1, 1, 5, 0))
    with pytest.raises(FormatError):
        qoi.encode(np.zeros(4, np.uint8), qoi.Desc(0, 1, 4, 0))


def test_encode_vec_byte_identical():
    """The vectorized encoder must emit byte-identical streams to the
    serial op emission (encoder.zig:29-132) across run caps, index-hit
    patterns (incl. the zero-initialized table edge), and both channel
    counts."""
    import numpy as np

    from zpix.codecs.qoi.encode import Desc, encode
    from zpix.codecs.qoi.encode_vec import encode_vec

    rng = np.random.default_rng(0)
    cases = []
    for i in range(16):
        w, h = int(rng.integers(1, 40)), int(rng.integers(1, 40))
        ch = 4 if i % 2 else 3
        style = i % 5
        if style == 0:
            a = rng.integers(0, 256, (h, w, ch), dtype=np.uint8)
        elif style == 1:
            a = np.full((h, w, ch), 13, np.uint8)
        elif style == 2:
            a = (np.arange(h * w * ch) % 7).astype(np.uint8).reshape(h, w, ch)
        elif style == 3:
            a = np.zeros((h, w, ch), np.uint8)  # table-init edge
        else:
            a = rng.integers(0, 3, (h, w, ch), dtype=np.uint8) * 100
            a[h // 2 :] = a[0, 0]  # runs > 62
        cases.append((a, ch))
    cases.append((np.full((3, 80, 4), 200, np.uint8), 4))  # multi-62 runs
    for j, (a, ch) in enumerate(cases):
        h, w = a.shape[:2]
        d = Desc(w, h, ch, 0)
        assert encode_vec(a, d) == encode(a, d), f"case {j}"
