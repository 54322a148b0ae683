"""BMP decode vs PNG decode differential parity.

Mirrors /root/reference/src/bmp/decoder_test.zig:24-69: 9 BMP/PNG pairs of
the same image must produce byte-identical RGBA flattens; empty input
errors cleanly.
"""

import os

import numpy as np
import pytest

from zpix.codecs import bmp, png
from zpix.errors import UnexpectedEof

PAIRS = [
    "bmp_1bpp",
    "bmp_4bpp",
    "bmp_8bpp",
    "colormap-0",
    "colormap-251",
    "colormap",
    "video-001",
    "yellow_rose-small-v5",
    "yellow_rose-small",
]


@pytest.mark.parametrize("name", PAIRS)
def test_bmp_png_parity(testdata, name):
    b = bmp.load(os.path.join(testdata, f"{name}.bmp"))
    p = png.load(os.path.join(testdata, f"{name}.png"))
    assert (b.width, b.height) == (p.width, p.height)
    assert np.array_equal(b.rgba_pixels(), p.rgba_pixels())


def test_empty_input():
    with pytest.raises(UnexpectedEof):
        bmp.decode(b"")


def test_probe(testdata):
    with open(os.path.join(testdata, "bmp_1bpp.bmp"), "rb") as f:
        assert bmp.probe_buffer(f.read(2))
    assert not bmp.probe_buffer(b"PNG")


def test_batch_bmp_device_parity(testdata):
    """Every corpus BMP decodes through the batched device path equal to
    the host decode's rgba_pixels flatten (decoder.zig:42-307 arms)."""
    import glob

    import numpy as np

    from zpix.codecs import bmp as bmp_codec
    from zpix.parallel.bmp_batch import BatchBmpDecoder

    files = sorted(glob.glob(os.path.join(testdata, "*.bmp")))
    assert len(files) >= 6
    for path in files:
        with open(path, "rb") as f:
            data = f.read()
        host = bmp_codec.decode(data)
        want = host.rgba_pixels().reshape(host.height, host.width, 4)
        out = np.asarray(BatchBmpDecoder().decode([data] * 2))
        assert np.array_equal(out[0], want), path
        assert np.array_equal(out[1], want), path
