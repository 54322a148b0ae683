"""QOI encoder.

Mirrors /root/reference/src/qoi/encoder.zig:29-151: op priority
run -> index -> diff -> luma -> rgb/rgba, 62-pixel run cap, run also flushed
on the final pixel, 8-byte end padding 0...01.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

from ...errors import FormatError

QOI_PIXELS_MAX = 400_000_000
_PADDING = bytes([0, 0, 0, 0, 0, 0, 0, 1])


@dataclass
class Desc:
    """Encode parameters (/root/reference/src/qoi/encoder.zig:20-25)."""

    width: int
    height: int
    channels: int  # 3 = RGB, 4 = RGBA
    colorspace: int  # 0 = sRGB + linear alpha, 1 = all linear


def encode(pixels, desc: Desc) -> bytes:
    if (
        desc.width == 0
        or desc.height == 0
        or desc.channels not in (3, 4)
        or desc.colorspace > 1
        or desc.height >= QOI_PIXELS_MAX // desc.width
    ):
        raise FormatError("qoi: bad encode descriptor")

    pix = np.asarray(pixels, np.uint8).reshape(-1)
    n = desc.width * desc.height
    if len(pix) < n * desc.channels:
        raise FormatError("qoi: pixel buffer too small")

    header = struct.pack(
        ">IIIBB", 0x716F6966, desc.width, desc.height, desc.channels, desc.colorspace
    )

    # Native fast path (zpix/runtime/qoi.cpp), identical op emission.
    from ... import runtime

    lib = runtime.get_lib()
    if lib is not None:
        import ctypes

        src = np.ascontiguousarray(pix[: n * desc.channels])
        cap = n * (desc.channels + 1) + 22
        buf = np.empty(cap, np.uint8)
        written = lib.zpix_qoi_encode(
            src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            n,
            desc.channels,
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            cap,
        )
        if written >= 0:
            return header + buf[:written].tobytes() + _PADDING

    out = bytearray()
    out += header

    index = [0] * 64
    pr, pg, pb, pa = 0, 0, 0, 255
    run = 0
    has_alpha = desc.channels == 4
    data = pix.tolist()
    ch = desc.channels
    append = out.append

    for i in range(n):
        base = i * ch
        r = data[base]
        g = data[base + 1]
        b = data[base + 2]
        a = data[base + 3] if has_alpha else pa

        if r == pr and g == pg and b == pb and a == pa:
            run += 1
            if run == 62 or i == n - 1:
                append(0xC0 | (run - 1))
                run = 0
        else:
            if run > 0:
                append(0xC0 | (run - 1))
                run = 0
            idx = (r * 3 + g * 5 + b * 7 + a * 11) & 63
            packed = (r << 24) | (g << 16) | (b << 8) | a
            if index[idx] == packed:
                append(idx)
            else:
                index[idx] = packed
                if a == pa:
                    vr = r - pr
                    vg = g - pg
                    vb = b - pb
                    vg_r = vr - vg
                    vg_b = vb - vg
                    if -3 < vr < 2 and -3 < vg < 2 and -3 < vb < 2:
                        append(0x40 | ((vr + 2) << 4) | ((vg + 2) << 2) | (vb + 2))
                    elif -9 < vg_r < 8 and -33 < vg < 32 and -9 < vg_b < 8:
                        append(0x80 | (vg + 32))
                        append(((vg_r + 8) << 4) | (vg_b + 8))
                    else:
                        append(0xFE)
                        append(r)
                        append(g)
                        append(b)
                else:
                    append(0xFF)
                    append(r)
                    append(g)
                    append(b)
                    append(a)
        pr, pg, pb, pa = r, g, b, a

    out += _PADDING
    return bytes(out)
