"""QOI decoder.

Op-stream semantics mirror /root/reference/src/qoi/decoder.zig:20-147:
OP_RGB/OP_RGBA/OP_INDEX/OP_DIFF/OP_LUMA/OP_RUN over a rolling 64-entry
index keyed by (3r+5g+7b+11a)&63, always producing a premultiplied-trivial
RGBA8 image (the stream is non-premultiplied but the reference stores it
into an RGBAImage unchanged; we keep that behavior for parity).

The op loop is serial by construction (index-table + previous-pixel state);
it runs once per *op*, with runs expanded by one vectorized np.repeat at the
end.  The batched device path runs this walk on the host (runtime/qoi.cpp)
and expands the runs on the device.
"""

from __future__ import annotations

import struct

import numpy as np

from ...errors import FormatError, UnexpectedEof
from ...image import Config, RGBAImage, Rectangle

QOI_HEADER_SIZE = 14
QOI_PADDING_SIZE = 8
QOI_PIXELS_MAX = 400_000_000

OP_INDEX = 0x00
OP_DIFF = 0x40
OP_LUMA = 0x80
OP_RUN = 0xC0
OP_RGB = 0xFE
OP_RGBA = 0xFF
MASK_2 = 0xC0


def probe_buffer(buf: bytes) -> bool:
    return len(buf) >= 4 and buf[:4] == b"qoif"


def _parse_header(data: bytes):
    if len(data) < QOI_HEADER_SIZE + QOI_PADDING_SIZE:
        raise FormatError("qoi: data too short")
    magic, width, height, channels, colorspace = struct.unpack(">IIIBB", data[:QOI_HEADER_SIZE])
    if magic != 0x716F6966:
        raise FormatError("qoi: bad magic")
    if (
        width == 0
        or height == 0
        or channels not in (3, 4)
        or colorspace > 1
        or height >= QOI_PIXELS_MAX // width
    ):
        raise FormatError("qoi: bad header")
    return width, height, channels, colorspace


def decode_config(data: bytes) -> Config:
    w, h, _, _ = _parse_header(data)
    return Config(w, h, "RGBA")


def decode(data: bytes) -> RGBAImage:
    width, height, _, _ = _parse_header(data)
    pixel_count = width * height
    chunks_len = len(data) - QOI_PADDING_SIZE

    # Native fast path (zpix/runtime/qoi.cpp), identical semantics.
    from ... import runtime

    lib = runtime.get_lib()
    if lib is not None:
        import ctypes

        out = np.empty((height, width, 4), np.uint8)
        rc = lib.zpix_qoi_decode(
            data,
            len(data),
            pixel_count,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        if rc == 0:
            return RGBAImage(out, Rectangle.init(0, 0, width, height))
        if rc == 2:
            raise UnexpectedEof("qoi: truncated op stream")

    # Per-op serial scan; runs recorded as counts and expanded vectorized.
    colors: list[int] = []  # packed 0xRRGGBBAA per emission group
    counts: list[int] = []
    index = [0] * 64  # packed rgba
    r, g, b, a = 0, 0, 0, 255
    px = 255  # packed
    produced = 0
    p = QOI_HEADER_SIZE
    d = data

    while produced < pixel_count:
        if p >= chunks_len:
            # Reference keeps emitting the current pixel once data runs out
            # (decoder.zig:67-69: run/read guards, else emit px unchanged).
            colors.append(px)
            counts.append(pixel_count - produced)
            produced = pixel_count
            break
        b1 = d[p]
        p += 1
        emit = 1
        if b1 == OP_RGB:
            if p + 3 > len(d):
                raise UnexpectedEof("qoi: truncated OP_RGB")
            r, g, b = d[p], d[p + 1], d[p + 2]
            p += 3
        elif b1 == OP_RGBA:
            if p + 4 > len(d):
                raise UnexpectedEof("qoi: truncated OP_RGBA")
            r, g, b, a = d[p], d[p + 1], d[p + 2], d[p + 3]
            p += 4
        else:
            tag = b1 & MASK_2
            if tag == OP_INDEX:
                packed = index[b1 & 0x3F]
                r = (packed >> 24) & 0xFF
                g = (packed >> 16) & 0xFF
                b = (packed >> 8) & 0xFF
                a = packed & 0xFF
            elif tag == OP_DIFF:
                r = (r + ((b1 >> 4) & 0x3) - 2) & 0xFF
                g = (g + ((b1 >> 2) & 0x3) - 2) & 0xFF
                b = (b + (b1 & 0x3) - 2) & 0xFF
            elif tag == OP_LUMA:
                if p >= len(d):
                    raise UnexpectedEof("qoi: truncated OP_LUMA")
                b2 = d[p]
                p += 1
                dg = (b1 & 0x3F) - 32
                r = (r + dg + ((b2 >> 4) & 0xF) - 8) & 0xFF
                g = (g + dg) & 0xFF
                b = (b + dg + (b2 & 0xF) - 8) & 0xFF
            else:  # OP_RUN
                emit = (b1 & 0x3F) + 1
        px = (r << 24) | (g << 16) | (b << 8) | a
        index[(r * 3 + g * 5 + b * 7 + a * 11) & 63] = px
        if emit > pixel_count - produced:
            emit = pixel_count - produced
        colors.append(px)
        counts.append(emit)
        produced += emit

    packed = np.repeat(np.array(colors, np.uint32), np.array(counts, np.int64))
    pix = packed.view(np.uint8).reshape(-1, 4)
    if pix.dtype.byteorder != ">" and np.little_endian:
        # packed as 0xRRGGBBAA big-endian semantics; on LE the view yields
        # [A,B,G,R] so flip channel order.
        pix = pix[:, ::-1]
    return RGBAImage(np.ascontiguousarray(pix.reshape(height, width, 4)), Rectangle.init(0, 0, width, height))
