#!/usr/bin/env python3
"""Seeded image corpus: PNG, BMP and QOI writers, and the committed JPEGs.

The tests and ``chip_smoke.py`` take every input from here, so nothing is
read from outside the repository:

* ``png_bytes`` writes any PNG the decoders accept (every color type and
  bit depth, tRNS, Adam7) with the standard library's ``zlib``;
* ``bmp_bytes`` writes 24-bit and paletted BMP;
* ``qoi_bytes`` encodes through ``zpix.codecs.qoi.encode``;
* ``write_jpegs`` regenerates ``testdata/*.jpg`` with Pillow.  Only that
  step needs Pillow; everything else reads the committed files.

Content comes from seeded NumPy generators (``photo``, ``screen``,
``noise``), so two runs give the same bytes.

    python tools/corpus.py      # rewrite testdata/*.jpg
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

TESTDATA = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "testdata"
)

# Large set: 4 distinct 1024x1024 4:2:0 q50 images, each encoded three
# ways (restart interval of 8 MCUs, no restarts, progressive).
LARGE_SIZE = 1024
LARGE_SEEDS = (0, 1, 2, 3)
LARGE_KINDS = ("dri8", "plain", "prog")
# Small set: (name, (height, width), Pillow save options, mode).
SMALL_JPEGS = (
    ("gray.jpg", (61, 83), dict(quality=75), "L"),
    ("444.jpg", (64, 48), dict(quality=90, subsampling=0), "RGB"),
    ("422.jpg", (40, 72), dict(quality=80, subsampling=1), "RGB"),
    ("420_dri.jpg", (40, 56), dict(quality=75, subsampling=2,
                                   restart_marker_blocks=1), "RGB"),
    ("cmyk_dri.jpg", (48, 64), dict(quality=85, restart_marker_blocks=2),
     "CMYK"),
    ("prog444.jpg", (56, 40), dict(quality=80, subsampling=0,
                                   progressive=True), "RGB"),
)


def large_name(seed: int, kind: str) -> str:
    return f"photo{seed}_{kind}.jpg"


def read(name: str) -> bytes:
    """Bytes of one committed file under testdata/."""
    with open(os.path.join(TESTDATA, name), "rb") as f:
        return f.read()


def large_batch(kind: str, batch: int) -> list:
    """A batch of large JPEGs of one kind, cycling the distinct images."""
    distinct = [read(large_name(s, kind)) for s in LARGE_SEEDS]
    return [distinct[i % len(distinct)] for i in range(batch)]


# ------------------------------------------------------------- content


def photo(h: int, w: int, seed: int) -> np.ndarray:
    """Photo-like RGB8 [h, w, 3]: smooth fields, flat objects, sensor noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    out = np.empty((h, w, 3), np.float32)
    for c in range(3):
        acc = np.zeros((h, w), np.float32)
        for _ in range(6):
            fx, fy = rng.uniform(0.002, 0.03, 2)
            ph = rng.uniform(0, 2 * np.pi)
            acc += rng.uniform(10, 40) * np.sin(fx * x + fy * y + ph) \
                * np.cos(fy * x - fx * y)
        out[..., c] = 128 + acc
    for _ in range(12):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        ry = rng.uniform(max(2, h / 50), max(3, h / 5))
        rx = rng.uniform(max(2, w / 50), max(3, w / 5))
        m = ((y - cy) / ry) ** 2 + ((x - cx) / rx) ** 2 < 1
        out[m] = out[m] * 0.5 + rng.uniform(0, 255, 3) * 0.5
    out += rng.normal(0, 6, (h, w, 3))
    return np.clip(out, 0, 255).astype(np.uint8)


def screen(h: int, w: int, seed: int) -> np.ndarray:
    """Screen-like opaque RGBA8: flat panels, a gradient band, ~2% glyph
    speckle (run-heavy, the content QOI was designed for)."""
    rng = np.random.RandomState(seed)
    rgba = np.zeros((h, w, 4), np.uint8)
    rgba[..., 3] = 255
    for _ in range(24):
        y0, x0 = rng.randint(0, h), rng.randint(0, w)
        ph, pw = rng.randint(max(1, h // 16), max(2, h // 3)), \
            rng.randint(max(1, w // 16), max(2, w // 3))
        rgba[y0 : y0 + ph, x0 : x0 + pw, :3] = rng.randint(30, 226, 3)
    gy = rng.randint(0, max(1, h - h // 8))
    grad = np.linspace(40, 215, w).astype(np.uint8)
    rgba[gy : gy + max(1, h // 8), :, :3] = grad[None, :, None]
    m = rng.rand(h, w) < 0.02
    rgba[..., :3][m] = rng.randint(0, 256, (int(m.sum()), 3))
    return rgba


def noise(h: int, w: int, seed: int) -> np.ndarray:
    """Noisy opaque RGBA8 over a smooth field: about one QOI op per pixel."""
    rng = np.random.RandomState(seed)
    rgb = photo(h, w, seed)
    rgb ^= rng.randint(0, 8, (h, w, 1)).astype(np.uint8)
    return np.concatenate([rgb, np.full((h, w, 1), 255, np.uint8)], -1)


# ------------------------------------------------------------- PNG


_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
          (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))  # (y0, x0, dy, dx)
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(tag: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + tag + body
            + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))


def _pack_rows(samples: np.ndarray, depth: int) -> np.ndarray:
    """[h, w, ch] samples -> [h, row_bytes] big-endian, MSB-first bytes."""
    h = samples.shape[0]
    flat = samples.reshape(h, -1)
    if depth == 16:
        return flat.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return flat.astype(np.uint8)
    bits = (flat[..., None].astype(np.uint8)
            >> np.arange(depth - 1, -1, -1, dtype=np.uint8)) & 1
    return np.packbits(bits.reshape(h, -1), axis=1)


def _filter_rows(rows: np.ndarray, bpp: int) -> bytes:
    """Filter row r with type r % 5 (None, Sub, Up, Average, Paeth), so
    every defilter arm runs."""
    cur = rows.astype(np.int16)
    up = np.vstack([np.zeros((1, rows.shape[1]), np.int16), cur[:-1]])
    left = np.hstack([np.zeros((rows.shape[0], bpp), np.int16), cur[:, :-bpp]])
    ul = np.hstack([np.zeros((rows.shape[0], bpp), np.int16), up[:, :-bpp]])
    p = left + up - ul
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
    preds = (np.zeros_like(cur), left, up, (left + up) >> 1, paeth)
    out = bytearray()
    for r in range(rows.shape[0]):
        ft = r % 5
        out.append(ft)
        out += ((cur[r] - preds[ft][r]) & 0xFF).astype(np.uint8).tobytes()
    return bytes(out)


def png_bytes(samples: np.ndarray, *, color_type: int, depth: int,
              palette: np.ndarray | None = None, trns=None,
              interlace: bool = False, level: int = 6) -> bytes:
    """Encode samples [h, w, channels] (palette indices for color type 3).

    palette: [n, 3] uint8 (PLTE).  trns: a gray value (type 0), an RGB
    triple (type 2) or per-entry alphas (type 3).
    """
    h, w = samples.shape[:2]
    ch = _CHANNELS[color_type]
    samples = samples.reshape(h, w, ch)
    bpp = max(1, ch * depth // 8)
    out = [b"\x89PNG\r\n\x1a\n",
           _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color_type,
                                       0, 0, int(interlace)))]
    if palette is not None:
        out.append(_chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes()))
    if trns is not None:
        if color_type == 3:
            body = np.asarray(trns, np.uint8).tobytes()
        else:
            body = b"".join(struct.pack(">H", int(v))
                            for v in np.atleast_1d(trns))
        out.append(_chunk(b"tRNS", body))
    if interlace:
        raw = b"".join(
            _filter_rows(_pack_rows(samples[y0::dy, x0::dx], depth), bpp)
            for y0, x0, dy, dx in _ADAM7
            if y0 < h and x0 < w
        )
    else:
        raw = _filter_rows(_pack_rows(samples, depth), bpp)
    out.append(_chunk(b"IDAT", zlib.compress(raw, level)))
    out.append(_chunk(b"IEND", b""))
    return b"".join(out)


def png_matrix(h: int = 29, w: int = 37, seed: int = 0) -> dict:
    """Every color type x bit depth, the three tRNS kinds and four Adam7
    files, all h x w: {name: png bytes}."""
    rng = np.random.RandomState(seed)
    out = {}
    for ct, depths in ((0, (1, 2, 4, 8, 16)), (2, (8, 16)), (3, (1, 2, 4, 8)),
                       (4, (8, 16)), (6, (8, 16))):
        for d in depths:
            hi = 1 << d
            s = rng.randint(0, hi, (h, w, _CHANNELS[ct]))
            pal = None
            if ct == 3:
                pal = rng.randint(0, 256, (hi, 3))
            out[f"ct{ct}_d{d}.png"] = png_bytes(s, color_type=ct, depth=d,
                                                palette=pal)
    g = rng.randint(0, 256, (h, w, 1))
    g[::3, ::2] = 77
    out["ct0_d8_trns.png"] = png_bytes(g, color_type=0, depth=8, trns=77)
    rgb = rng.randint(0, 4, (h, w, 3)) * 85
    out["ct2_d8_trns.png"] = png_bytes(rgb, color_type=2, depth=8,
                                       trns=(85, 170, 0))
    idx = rng.randint(0, 16, (h, w, 1))
    out["ct3_d4_trns.png"] = png_bytes(
        idx, color_type=3, depth=4, palette=rng.randint(0, 256, (16, 3)),
        trns=rng.randint(0, 256, 12))
    for ct, d in ((0, 16), (2, 8), (3, 4), (6, 8)):
        s = rng.randint(0, 1 << d, (h, w, _CHANNELS[ct]))
        pal = rng.randint(0, 256, (1 << d, 3)) if ct == 3 else None
        out[f"ct{ct}_d{d}_adam7.png"] = png_bytes(
            s, color_type=ct, depth=d, palette=pal, interlace=True)
    return out


# ------------------------------------------------------------- BMP


def bmp_bytes(pixels: np.ndarray, *, palette: np.ndarray | None = None,
              bpp: int = 24, top_down: bool = False) -> bytes:
    """BITMAPINFOHEADER BMP.  24-bit: pixels is RGB8 [h, w, 3].
    Paletted (bpp 1/4/8): pixels is indices [h, w], palette [n, 3] RGB."""
    h, w = pixels.shape[:2]
    if bpp == 24:
        rows = pixels[..., ::-1].reshape(h, 3 * w).astype(np.uint8)
    else:
        bits = (pixels[..., None].astype(np.uint8)
                >> np.arange(bpp - 1, -1, -1, dtype=np.uint8)) & 1
        rows = np.packbits(bits.reshape(h, -1), axis=1) if bpp < 8 \
            else pixels.astype(np.uint8)
    stride = (rows.shape[1] + 3) // 4 * 4
    body = np.zeros((h, stride), np.uint8)
    body[:, : rows.shape[1]] = rows
    if not top_down:
        body = body[::-1]
    pal = b""
    if palette is not None:
        bgra = np.zeros((len(palette), 4), np.uint8)
        bgra[:, :3] = np.asarray(palette, np.uint8)[:, ::-1]
        pal = bgra.tobytes()
    off = 14 + 40 + len(pal)
    info = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1, bpp,
                       0, body.size, 2835, 2835,
                       len(palette) if palette is not None else 0, 0)
    head = struct.pack("<2sIHHI", b"BM", off + body.size, 0, 0, off)
    return head + info + pal + body.tobytes()


def bmp_set(h: int = 23, w: int = 31, seed: int = 0) -> dict:
    """24-bit (bottom-up and top-down) and 1/4/8-bit paletted BMPs."""
    rng = np.random.RandomState(seed)
    out = {
        "rgb24.bmp": bmp_bytes(photo(h, w, seed)),
        "rgb24_topdown.bmp": bmp_bytes(photo(h, w, seed + 1), top_down=True),
    }
    for bpp in (1, 4, 8):
        n = 1 << bpp
        out[f"pal{bpp}.bmp"] = bmp_bytes(rng.randint(0, n, (h, w)),
                                         palette=rng.randint(0, 256, (n, 3)),
                                         bpp=bpp)
    return out


# ------------------------------------------------------------- QOI


def qoi_bytes(rgba: np.ndarray) -> bytes:
    from zpix.codecs.qoi.encode import Desc, encode

    h, w, ch = rgba.shape
    return encode(np.ascontiguousarray(rgba), Desc(w, h, ch, 0))


# ------------------------------------------------------------- JPEG


def write_jpegs(out_dir: str = TESTDATA) -> list:
    """Regenerate the committed JPEGs with Pillow; returns the paths."""
    from io import BytesIO

    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    jobs = []
    for seed in LARGE_SEEDS:
        img = Image.fromarray(photo(LARGE_SIZE, LARGE_SIZE, 100 + seed))
        base = dict(quality=50, subsampling=2)
        for kind, extra in zip(LARGE_KINDS, (dict(restart_marker_blocks=8),
                                             {}, dict(progressive=True))):
            jobs.append((large_name(seed, kind), img, {**base, **extra}))
    for i, (name, (h, w), opts, mode) in enumerate(SMALL_JPEGS):
        rgb = photo(h, w, 200 + i)
        if mode == "L":
            img = Image.fromarray(rgb[..., 0])
        elif mode == "CMYK":
            cmyk = np.concatenate([rgb, 255 - rgb[..., :1]], -1)
            img = Image.fromarray(cmyk, "CMYK")
        else:
            img = Image.fromarray(rgb)
        jobs.append((name, img, opts))
    paths = []
    for name, img, opts in jobs:
        buf = BytesIO()
        img.save(buf, format="JPEG", **opts)
        path = os.path.join(out_dir, name)
        with open(path, "wb") as f:
            f.write(buf.getvalue())
        paths.append(path)
    return paths


if __name__ == "__main__":
    for p in write_jpegs():
        print(f"{os.path.getsize(p):8d}  {os.path.relpath(p)}")
