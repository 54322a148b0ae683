"""Exact-integer color conversion unit tests.

Scalar reference semantics transcribed from
/root/reference/src/color/color.zig; the vectorized implementations must
agree on exhaustive/boundary inputs.
"""

import numpy as np

from zpix.color import (
    cmyk_to_rgba16,
    gray_coeff_luma,
    rgb_to_cmyk,
    rgb_to_ycbcr,
    ycbcr_to_rgb8,
    ycbcr_to_rgba16,
)


def _scalar_ycbcr_rgb8(y, cb, cr):
    """drawYCbCr inner math (/root/reference/src/image/util.zig:40-86)."""
    yy1 = y * 0x10101
    cb1 = cb - 128
    cr1 = cr - 128

    def clamp(v):
        # if (u32(v) & 0xff000000) == 0: v >> 16 else ~(v >> 31) & 0xff
        if (v & 0xFFFFFFFF) & 0xFF000000 == 0:
            return v >> 16
        return (~(v >> 31)) & 0xFF

    r = clamp(yy1 + 91881 * cr1)
    g = clamp(yy1 - 22554 * cb1 - 46802 * cr1)
    b = clamp(yy1 + 116130 * cb1)
    return r, g, b


def test_ycbcr_to_rgb8_exhaustive_grid():
    ys = np.arange(0, 256, 5, dtype=np.uint8)
    cbs = np.arange(0, 256, 7, dtype=np.uint8)
    crs = np.arange(0, 256, 11, dtype=np.uint8)
    Y, CB, CR = np.meshgrid(ys, cbs, crs, indexing="ij")
    r, g, b = ycbcr_to_rgb8(Y, CB, CR)
    step = 6
    for i in np.ndindex(*(max(1, d // step) for d in Y.shape)):
        i = tuple(v * step for v in i)
        y, cb, cr = int(Y[i]), int(CB[i]), int(CR[i])
        er, eg, eb = _scalar_ycbcr_rgb8(y, cb, cr)
        assert (int(r[i]), int(g[i]), int(b[i])) == (er, eg, eb)


def test_ycbcr_16bit_vs_8bit_consistency():
    """toRGBA>>8 must equal the 8-bit form for every value (the reference's
    two kernels differ only in output width)."""
    rng = np.random.default_rng(3)
    y = rng.integers(0, 256, 4096, dtype=np.uint8)
    cb = rng.integers(0, 256, 4096, dtype=np.uint8)
    cr = rng.integers(0, 256, 4096, dtype=np.uint8)
    r16, g16, b16 = ycbcr_to_rgba16(y, cb, cr)
    r8, g8, b8 = ycbcr_to_rgb8(y, cb, cr)
    assert np.array_equal(r16 >> 8, r8)
    assert np.array_equal(g16 >> 8, g8)
    assert np.array_equal(b16 >> 8, b8)


def test_rgb_ycbcr_roundtrip_tolerance():
    """Forward->inverse must be within the usual fixed-point error."""
    rng = np.random.default_rng(5)
    r = rng.integers(0, 256, 1000, dtype=np.uint8)
    g = rng.integers(0, 256, 1000, dtype=np.uint8)
    b = rng.integers(0, 256, 1000, dtype=np.uint8)
    y, cb, cr = rgb_to_ycbcr(r, g, b)
    r2, g2, b2 = ycbcr_to_rgb8(y, cb, cr)
    assert np.abs(r2.astype(int) - r.astype(int)).max() <= 3
    assert np.abs(g2.astype(int) - g.astype(int)).max() <= 3
    assert np.abs(b2.astype(int) - b.astype(int)).max() <= 3


def test_rgb_to_ycbcr_known_values():
    # Black, white, pure red (JFIF formulas).
    y, cb, cr = rgb_to_ycbcr(
        np.array([0, 255, 255], np.uint8),
        np.array([0, 255, 0], np.uint8),
        np.array([0, 255, 0], np.uint8),
    )
    assert list(y) == [0, 255, 76]
    assert list(cb) == [128, 128, 85]
    assert list(cr) == [128, 128, 255]


def test_cmyk_conversions():
    c, m, y, k = rgb_to_cmyk(
        np.array([255, 0, 128], np.uint8),
        np.array([0, 0, 128], np.uint8),
        np.array([0, 0, 128], np.uint8),
    )
    assert (int(c[0]), int(m[0]), int(y[0]), int(k[0])) == (0, 255, 255, 0)
    assert (int(c[1]), int(m[1]), int(y[1]), int(k[1])) == (0, 0, 0, 255)
    # Round-trip through cmyk_to_rgba16 for the gray case.
    r, g, b = cmyk_to_rgba16(c[2:], m[2:], y[2:], k[2:])
    assert int(r[0]) >> 8 == 128


def test_gray_coefficients():
    """19595 + 38470 + 7471 == 65536; white -> 255, black -> 0."""
    r = np.array([0xFFFF, 0], np.int32)
    y = gray_coeff_luma(r, r, r)
    assert list(y) == [255, 0]
