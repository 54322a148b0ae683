"""Batched PNG decode: host front-end -> device defilter/expand/merge.

Three front-end tiers, most-on-device first:

- device_inflate=True — two-pass inflate (SURVEY.md hard part 3): the
  host runs ONLY the bit-serial DEFLATE symbol-resolve
  (runtime/inflate.cpp, never materializing the 32 KiB window); LZ77
  copy-resolve runs on device as a pointer-doubling scan
  (ops/inflate.py) fused with the wavefront defilter, expansion, and
  any Adam7 scatter merge into one compiled graph.  Token uploads cost
  6 B/token vs 1 B/byte for inflated rows, so streams that compress
  well also shrink the host->device link traffic.
- device_defilter=True — host inflate (libdeflate with the exact
  IHDR-derived size, else zlib); the filter recurrence + expansion run
  on device.
- default — host inflate + native SSE2 defilter; expansion on device.

Why full Huffman decode is not speculated on device like JPEG
(measured reasoning, kept from round 1): DEFLATE dynamic blocks carry
data-dependent ~300-entry code tables, which a speculative chunk lane
(the device_entropy_sync machinery) would have to rebuild as per-lane
state through the fixed-point iteration.  The two-pass split keeps the
host's share at the irreducible bit-serial part and moves the
data-parallel remainder (copy resolution onward) on chip.

Covered depths: the full matrix (g1..g16, ga8/16, tc8/16, tca8/16,
p1..p8) + Adam7 + tRNS in both forms (paletted alpha via the gather
palette; gray/truecolor color keys as per-image [3] compare values,
matched in the depth's native domain pre-truncation).
"""

from __future__ import annotations

import zlib

import numpy as np

from ..codecs.png.decode import (
    _BITS_PER_PIXEL,
    INTERLACING,
    _pass_dims,
    _State,
    _parse_ihdr,
    _parse_plte,
    _parse_trns,
    _walk_chunks,
)
from ..errors import FormatError, UnsupportedError
from ..image.model import PALETTE_NRGBA


def _walk_idat(data: bytes):
    """Chunk walk: returns (state, concatenated IDAT, exact inflated size)."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise FormatError("png: invalid signature")
    st = _State()
    idat = bytearray()
    for ctype, payload in _walk_chunks(data):
        if ctype == b"IHDR":
            _parse_ihdr(st, payload)
        elif ctype == b"PLTE":
            _parse_plte(st, payload)
        elif ctype == b"tRNS":
            _parse_trns(st, payload)
        elif ctype == b"IDAT":
            idat += payload
    # IHDR fixes the inflated size exactly (per pass for Adam7)
    bits = _BITS_PER_PIXEL[st.color_depth]
    if st.interlace:
        expected = sum(
            ph * (1 + (bits * pw + 7) // 8)
            for pw, ph in (
                _pass_dims(st.width, st.height, p) for p in range(7)
            )
            if pw > 0 and ph > 0
        )
    else:
        expected = st.height * (1 + (bits * st.width + 7) // 8)
    return st, bytes(idat), expected


def parse_filtered(data: bytes):
    """Chunk walk + inflate: returns (state, raw filtered bytes)."""
    from .. import runtime

    st, idat, expected = _walk_idat(data)
    raw = runtime.zlib_decompress_sized(idat, expected)
    if raw is None:
        raw = zlib.decompress(idat)
    return st, raw


def parse_tokens(data: bytes):
    """Chunk walk + DEFLATE symbol-resolve: the host half of the two-pass
    inflate (runtime/inflate.cpp).  Returns (state, lens, dists, lits);
    the copy-resolve half runs on device (ops/inflate.py)."""
    from .. import runtime

    st, idat, expected = _walk_idat(data)
    toks = runtime.inflate_tokens(idat, expected)
    if toks is None:
        raise UnsupportedError("png: native runtime required for device inflate")
    lens, dists, lits, out_bytes = toks
    if out_bytes != expected:
        raise FormatError("png: inflated size mismatch")
    return st, lens, dists, lits


_JITTED: dict = {}


def _jit(name, fn, static=()):
    if name not in _JITTED:
        import jax

        _JITTED[name] = jax.jit(fn, static_argnames=static)
    return _JITTED[name]


def _keyed(jnp, px, match):
    """Zero out key-matched pixels: NRGBA alpha-0 premultiplies to
    (0,0,0,0) in rgba_pixels, so the RGBA8 output is all-zero there
    (tRNS color key, decoder.zig:547-576 + the expansion arms)."""
    if match is None:
        return px
    return jnp.where(match[..., None], jnp.uint8(0), px)


def _expand_tc8(rows, key=None):
    """[B, H, W*3] uint8 -> [B, H, W, 4] RGBA8 opaque."""
    import jax.numpy as jnp

    b, h, wc = rows.shape
    rgb = rows.reshape(b, h, wc // 3, 3)
    a = jnp.full(rgb.shape[:-1] + (1,), 255, jnp.uint8)
    match = None
    if key is not None:
        match = jnp.all(
            rgb.astype(jnp.int32) == key[:, None, None, :], axis=-1
        )
    return _keyed(jnp, jnp.concatenate([rgb, a], axis=-1), match)


def _expand_tca8(rows):
    """Non-premultiplied RGBA8 -> premultiplied, the reference's exact
    rgbaPixels math: ((c | c<<8) * a // 0xff) >> 8
    (/root/reference/src/image/image.zig:103-130 via color.zig nrgba arm).
    """
    import jax.numpy as jnp

    b, h, wc = rows.shape
    px = rows.reshape(b, h, wc // 4, 4).astype(jnp.int32)
    a = px[..., 3:4]
    wide = px[..., :3] | (px[..., :3] << 8)
    rgb = ((wide * a) // 0xFF) >> 8
    return jnp.concatenate([rgb, a], axis=-1).astype(jnp.uint8)


def _expand_g8(rows, key=None):
    import jax.numpy as jnp

    b, h, w = rows.shape
    a = jnp.full((b, h, w, 1), 255, jnp.uint8)
    g = rows[..., None]
    match = None
    if key is not None:
        match = rows.astype(jnp.int32) == key[:, None, None, 0]
    return _keyed(jnp, jnp.concatenate([g, g, g, a], axis=-1), match)


def _expand_p8(rows, palette):
    """[B, H, W] indices + [B, 256, 4] palette -> RGBA via device gather."""
    import jax.numpy as jnp

    batch_idx = jnp.arange(palette.shape[0])[:, None, None]
    return palette[batch_idx, rows.astype(jnp.int32)]


def _be16(jnp, rows, n):
    """[B, H, 2n] big-endian byte pairs -> [B, H, n] int32 in [0, 0xffff]."""
    b = rows.reshape(rows.shape[0], rows.shape[1], n, 2).astype(jnp.int32)
    return (b[..., 0] << 8) | b[..., 1]


def _expand_g16(rows, *, width, key=None):
    """Gray16 -> premultiplied RGBA8 (y >> 8 per rgbaPixels semantics).
    The color key compares in the 16-bit domain, before truncation."""
    import jax.numpy as jnp

    y16 = _be16(jnp, rows, width)
    y = (y16 >> 8).astype(jnp.uint8)
    a = jnp.full(y.shape + (1,), 255, jnp.uint8)
    g = y[..., None]
    match = None if key is None else y16 == key[:, None, None, 0]
    return _keyed(jnp, jnp.concatenate([g, g, g, a], axis=-1), match)


def _expand_tc16(rows, *, width, key=None):
    """RGB16 -> RGBA8 (channels >> 8); key compares pre-truncation."""
    import jax.numpy as jnp

    rgb16 = _be16(jnp, rows, width * 3)
    rgb16 = rgb16.reshape(rgb16.shape[0], rgb16.shape[1], width, 3)
    rgb = (rgb16 >> 8).astype(jnp.uint8)
    a = jnp.full(rgb.shape[:-1] + (1,), 255, jnp.uint8)
    match = None
    if key is not None:
        match = jnp.all(rgb16 == key[:, None, None, :], axis=-1)
    return _keyed(jnp, jnp.concatenate([rgb, a], axis=-1), match)


def _expand_tca16(rows, *, width):
    """Non-premultiplied RGBA16 -> premultiplied RGBA8.

    Exact rgbaPixels math: ((c * a) // 0xffff) >> 8, alpha >> 8
    (/root/reference/src/image/image.zig via color.zig nrgba64 arm).
    """
    import jax.numpy as jnp

    px = _be16(jnp, rows, width * 4).reshape(rows.shape[0], rows.shape[1], width, 4)
    px = px.astype(jnp.uint32)  # c * a reaches 0xfffe0001: past int32
    a = px[..., 3:4]
    rgb = (((px[..., :3] * a) // 0xFFFF) >> 8).astype(jnp.uint8)
    return jnp.concatenate([rgb, (a >> 8).astype(jnp.uint8)], axis=-1)


def _expand_ga8(rows, *, width):
    """Gray+alpha8 -> premultiplied RGBA8: ((y|y<<8)*a//0xff)>>8."""
    import jax.numpy as jnp

    d = rows.reshape(rows.shape[0], rows.shape[1], width, 2).astype(jnp.int32)
    y, a = d[..., 0:1], d[..., 1:2]
    g = ((((y | (y << 8)) * a) // 0xFF) >> 8).astype(jnp.uint8)
    return jnp.concatenate([g, g, g, a.astype(jnp.uint8)], axis=-1)


def _expand_ga16(rows, *, width):
    """Gray16+alpha16 -> premultiplied RGBA8."""
    import jax.numpy as jnp

    d = _be16(jnp, rows, width * 2).reshape(rows.shape[0], rows.shape[1], width, 2)
    d = d.astype(jnp.uint32)  # y * a reaches 0xfffe0001: past int32
    y, a = d[..., 0:1], d[..., 1:2]
    g = (((y * a) // 0xFFFF) >> 8).astype(jnp.uint8)
    return jnp.concatenate([g, g, g, (a >> 8).astype(jnp.uint8)], axis=-1)


def _expand_lowbit_gray(rows, *, width, depth, key=None):
    """g1/g2/g4 -> RGBA8 via device bit unpack + scale.  The key arrives
    pre-scaled by _parse_trns's bit-depth multiplier, matching the host
    comparison domain (decoder.zig:548-565)."""
    import jax.numpy as jnp

    bits = jnp.unpackbits(rows, axis=-1)  # [B, H, row_bytes*8]
    grouped = bits.reshape(bits.shape[0], bits.shape[1], -1, depth).astype(jnp.int32)
    weights = (1 << jnp.arange(depth - 1, -1, -1, dtype=jnp.int32))
    vals = (grouped * weights).sum(axis=-1)[:, :, :width]
    scale = {1: 0xFF, 2: 0x55, 4: 0x11}[depth]
    y = (vals * scale).astype(jnp.uint8)
    a = jnp.full(y.shape + (1,), 255, jnp.uint8)
    g = y[..., None]
    match = None
    if key is not None:
        match = y.astype(jnp.int32) == key[:, None, None, 0]
    return _keyed(jnp, jnp.concatenate([g, g, g, a], axis=-1), match)


def _expand_lowbit_palette(rows, palette, *, width, depth):
    """p1/p2/p4 -> RGBA8: device bit unpack + palette gather."""
    import jax.numpy as jnp

    bits = jnp.unpackbits(rows, axis=-1)
    grouped = bits.reshape(bits.shape[0], bits.shape[1], -1, depth).astype(jnp.int32)
    weights = (1 << jnp.arange(depth - 1, -1, -1, dtype=jnp.int32))
    idx = (grouped * weights).sum(axis=-1)[:, :, :width]
    batch_idx = jnp.arange(palette.shape[0])[:, None, None]
    return palette[batch_idx, idx]


def _interlaced_graph(cd, passes, palette, *, bpp, pass_meta, width, height,
                      key=None):
    """Adam7 on device: per-pass wavefront defilter + expansion, then a
    strided scatter into the full canvas (mergePassInto,
    /root/reference/src/png/decoder.zig:1289-1373)."""
    import jax.numpy as jnp

    from ..ops.defilter import defilter_jnp

    B = passes[0][0].shape[0]
    canvas = jnp.zeros((B, height, width, 4), jnp.uint8)
    for (p, pw, ph), (rows, ft) in zip(pass_meta, passes):
        dec = defilter_jnp(rows, ft, bpp=bpp)
        px = _expand_graph(cd, dec, palette, width=pw, key=key)
        xo, yo, xf, yf = INTERLACING[p]
        canvas = canvas.at[
            :, yo : yo + ph * yf : yf, xo : xo + pw * xf : xf
        ].set(px)
    return canvas


def _expand_graph(cd: str, rows, palette, *, width: int, key=None):
    """Shared expansion dispatch: defiltered rows -> RGBA8 device graph.
    key: [B, 3] int32 per-image tRNS color key (-1 rows = opaque)."""
    if cd == "tc8":
        return _expand_tc8(rows, key=key)
    if cd == "tca8":
        return _expand_tca8(rows)
    if cd == "g8":
        return _expand_g8(rows, key=key)
    if cd == "g16":
        return _expand_g16(rows, width=width, key=key)
    if cd == "tc16":
        return _expand_tc16(rows, width=width, key=key)
    if cd == "tca16":
        return _expand_tca16(rows, width=width)
    if cd == "ga8":
        return _expand_ga8(rows, width=width)
    if cd == "ga16":
        return _expand_ga16(rows, width=width)
    if cd in ("g1", "g2", "g4"):
        return _expand_lowbit_gray(rows, width=width, depth=int(cd[1]), key=key)
    if cd == "p8":
        return _expand_p8(rows, palette)
    return _expand_lowbit_palette(rows, palette, width=width, depth=int(cd[1]))


class BatchPngDecoder:
    """Same-shape batched PNG -> device RGBA8 [B, H, W, 4].

    device_defilter=True moves the per-row filter recurrence onto the
    chip too (ops/defilter.py wavefront scan, exact) — the host then
    only inflates; filtered bytes upload unchanged in size.

    Corrupt-input strictness differs by front-end: the host front-ends
    (libdeflate/zlib, like the reference's std.compress.flate) reject a
    stream whose zlib adler32 trailer doesn't match, while the
    device_inflate tokenizer (runtime/inflate.cpp) never materializes
    the inflated bytes on the host and skips that checksum — a
    checksum-corrupted-but-structurally-valid stream decodes
    successfully there.  Structural errors (bad Huffman codes, length
    mismatches) are still rejected by every front-end."""

    def __init__(self, mesh=None, n_threads: int | None = None,
                 device_defilter: bool | None = None,
                 device_inflate: bool | None = None):
        import os

        self.mesh = mesh
        self.n_threads = n_threads or (os.cpu_count() or 2)
        if device_defilter is None:
            device_defilter = os.environ.get("ZPIX_DEVICE_DEFILTER", "0") == "1"
        self.device_defilter = device_defilter
        if device_inflate is None:
            device_inflate = os.environ.get("ZPIX_DEVICE_INFLATE", "0") == "1"
        # device_inflate subsumes device_defilter: the resolved bytes are
        # already on device, so the filter recurrence runs there too.
        self.device_inflate = device_inflate

    def _shard(self, arr):
        if self.mesh is None:
            return arr
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P

        return jax.device_put(arr, NamedSharding(self.mesh, P("batch")))

    def decode(self, datas: list[bytes]):
        from .. import runtime
        from ..utils import metrics, trace

        if not datas:
            raise ValueError("png: empty batch")
        front = parse_tokens if self.device_inflate else parse_filtered
        with trace("png_batch.inflate"):
            if len(datas) > 1 and (self.n_threads or 2) > 1:
                # Both front-ends release the GIL (zlib.decompress /
                # the native tokenizer): run images in parallel
                from concurrent.futures import ThreadPoolExecutor

                with ThreadPoolExecutor(max_workers=self.n_threads or 2) as ex:
                    parsed = list(ex.map(front, datas))
            else:
                parsed = [front(d) for d in datas]
        metrics.count("png_batch.images", len(datas))
        st0 = parsed[0][0]
        for st, *_ in parsed[1:]:
            # interlace is part of the layout contract: with
            # device_inflate=True the per-image token totals differ
            # between interlaced and non-interlaced streams of the same
            # dims, so a mixed batch would silently decode wrong pixels
            # instead of raising.
            if (st.width, st.height, st.color_depth, st.interlace) != (
                st0.width,
                st0.height,
                st0.color_depth,
                st0.interlace,
            ):
                raise ValueError(
                    "batch images must share (width, height, depth, interlace)"
                )
        cd = st0.color_depth
        supported = {
            "g1", "g2", "g4", "g8", "g16", "ga8", "ga16",
            "tc8", "tc16", "tca8", "tca16", "p1", "p2", "p4", "p8",
        }
        if cd not in supported:
            raise UnsupportedError(f"png: batched path does not cover {cd}")

        # tRNS color key: per-image [3] comparison values in the depth's
        # native domain (-1 = no key, never matches unsigned samples);
        # the expansion arms zero matching pixels (decoder.zig:547-576).
        key_dev = None
        if any(pr[0].use_transparent for pr in parsed):
            key = np.full((len(parsed), 3), -1, np.int32)
            for i, pr in enumerate(parsed):
                st = pr[0]
                if not st.use_transparent:
                    continue
                t = st.transparent
                if cd in ("g1", "g2", "g4", "g8"):
                    key[i] = t[1]  # pre-scaled by _parse_trns
                elif cd == "g16":
                    key[i] = (t[0] << 8) | t[1]
                elif cd == "tc8":
                    key[i] = (t[1], t[3], t[5])
                elif cd == "tc16":
                    key[i] = (
                        (t[0] << 8) | t[1],
                        (t[2] << 8) | t[3],
                        (t[4] << 8) | t[5],
                    )
                else:  # pragma: no cover — _parse_trns rejects these
                    raise UnsupportedError(f"png: tRNS with {cd}")
            key_dev = self._shard(key)

        bpp_bits = _BITS_PER_PIXEL[cd]
        bpp = (bpp_bits + 7) // 8
        row_bytes = (bpp_bits * st0.width + 7) // 8
        h = st0.height

        # Paletted: stack palettes (may differ per image).  tRNS entries are
        # non-premultiplied (PALETTE_NRGBA); fold the premultiply into the
        # gather table so the device output matches rgba_pixels exactly
        # (image/model.py palette_rgba16, truncated to 8 bit).
        pal_dev = None
        if cd.startswith("p"):
            # Entries past the real palette are opaque black — the
            # reference auto-extends for out-of-range pixel indices
            # (decoder.zig:1086-1130; Go pre-fills opaque black).
            pal = np.zeros((len(parsed), 256, 4), np.uint8)
            pal[:, :, 3] = 0xFF
            for i, (st, *_) in enumerate(parsed):
                p = st.palette.astype(np.uint32)
                is_n = st.palette_kinds == PALETTE_NRGBA
                a = p[:, 3:4]
                wide = p[:, :3] | (p[:, :3] << 8)
                pre = np.where(is_n[:, None], ((wide * a) // 0xFF) >> 8, p[:, :3])
                pal[i, : len(p), :3] = pre
                pal[i, : len(p), 3] = p[:, 3]
            pal_dev = self._shard(pal)

        if self.device_inflate:
            # Two-pass inflate: host symbol-resolve tokens upload instead
            # of inflated bytes; copy-resolve (ops/inflate.py), defilter,
            # expansion, and any Adam7 merge are ONE device graph.
            # Tokens stack [B, NT] (len-0 padding) so the resolve vmaps
            # per image and shards on the batch axis.
            import jax

            from ..ops.defilter import defilter_jnp
            from ..ops.inflate import resolve_tokens_jnp

            bits = _BITS_PER_PIXEL[cd]
            if st0.interlace:
                seg_meta = []
                for p in range(7):
                    pw, ph = _pass_dims(st0.width, st0.height, p)
                    if pw == 0 or ph == 0:
                        continue
                    rb = (bits * pw + 7) // 8
                    seg_meta.append((p, pw, ph, rb))
                per = sum(ph * (1 + rb) for _, _, ph, rb in seg_meta)
            else:
                per = h * (1 + row_bytes)
            nt = max(len(pr[1]) for pr in parsed)
            nt = max(4096, 1 << (nt - 1).bit_length())  # pow2: bound recompiles
            B = len(parsed)
            lens = np.zeros((B, nt), np.int32)
            dists = np.zeros((B, nt), np.int32)
            lits = np.zeros((B, nt), np.uint8)
            for i, (_, ln, ds, lt) in enumerate(parsed):
                lens[i, : len(ln)] = ln
                dists[i, : len(ds)] = ds
                lits[i, : len(lt)] = lt
            lens, dists, lits = (
                self._shard(lens), self._shard(dists), self._shard(lits)
            )

            def fused(L, D, C, palette, key):
                flat = jax.vmap(
                    lambda l, d, c: resolve_tokens_jnp(l, d, c, per)
                )(L, D, C)
                if st0.interlace:
                    passes, meta, off = [], [], 0
                    for p, pw, ph, rb in seg_meta:
                        need = ph * (1 + rb)
                        seg = flat[:, off : off + need].reshape(B, ph, 1 + rb)
                        off += need
                        meta.append((p, pw, ph))
                        passes.append((seg[:, :, 1:], seg[:, :, 0]))
                    return _interlaced_graph(
                        cd, passes, palette, bpp=bpp, pass_meta=tuple(meta),
                        width=st0.width, height=st0.height, key=key,
                    )
                stacked = flat.reshape(B, h, 1 + row_bytes)
                dec = defilter_jnp(stacked[:, :, 1:], stacked[:, :, 0], bpp=bpp)
                return _expand_graph(cd, dec, palette, width=st0.width, key=key)

            fn = _jit(
                f"png_devinf_{cd}_{st0.width}x{h}_{st0.interlace}_{B}_{nt}"
                f"_k{key_dev is not None}",
                fused,
            )
            return fn(lens, dists, lits, pal_dev, key_dev)

        if st0.interlace:
            # Adam7: per-pass device defilter + expansion + strided
            # scatter, all one jitted graph.
            passes, meta = [], []
            offset = 0
            for p in range(7):
                pw, ph = _pass_dims(st0.width, st0.height, p)
                if pw == 0 or ph == 0:
                    continue
                rb = (bpp_bits * pw + 7) // 8
                need = ph * (1 + rb)
                seg = np.stack([
                    np.frombuffer(pr[1], np.uint8)[offset : offset + need]
                    .reshape(ph, 1 + rb)
                    for pr in parsed
                ])
                offset += need
                meta.append((p, pw, ph))
                passes.append((
                    self._shard(np.ascontiguousarray(seg[:, :, 1:])),
                    self._shard(np.ascontiguousarray(seg[:, :, 0])),
                ))
            fn = _jit(
                f"png_adam7_{cd}_{st0.width}x{st0.height}_{len(datas)}"
                f"_k{key_dev is not None}",
                lambda ps, pal, key: _interlaced_graph(
                    cd, ps, pal, bpp=bpp, pass_meta=tuple(meta),
                    width=st0.width, height=st0.height, key=key,
                ),
            )
            return fn(passes, pal_dev, key_dev)

        if self.device_defilter:
            # Filter bytes stay in the upload (same byte count); defilter
            # + expansion run as ONE device graph (ops/defilter.py).
            from ..ops.defilter import defilter_jnp

            stacked = np.stack([
                np.frombuffer(p[1], np.uint8)[: h * (row_bytes + 1)].reshape(
                    h, row_bytes + 1
                )
                for p in parsed
            ])
            ftypes = self._shard(np.ascontiguousarray(stacked[:, :, 0]))
            raw_rows = self._shard(np.ascontiguousarray(stacked[:, :, 1:]))

            def fused(rows, ft, palette, key):
                dec = defilter_jnp(rows, ft, bpp=bpp)
                return _expand_graph(cd, dec, palette, width=st0.width, key=key)

            fn = _jit(
                f"png_dev_{cd}_{bpp}_{st0.width}_k{key_dev is not None}", fused
            )
            return fn(raw_rows, ftypes, pal_dev, key_dev)

        lib = runtime.get_lib()
        outs = np.empty((len(datas), h, row_bytes), np.uint8)
        with trace("png_batch.defilter"):
            if lib is not None:
                import ctypes

                raws = [bytes(p[1][: h * (row_bytes + 1)]) for p in parsed]
                raw_ptrs = (ctypes.c_char_p * len(raws))(*raws)
                out_ptrs = (ctypes.POINTER(ctypes.c_uint8) * len(raws))()
                for i in range(len(raws)):
                    out_ptrs[i] = outs[i].ctypes.data_as(
                        ctypes.POINTER(ctypes.c_uint8)
                    )
                rc = lib.zpix_defilter_batch(
                    raw_ptrs, h, row_bytes, bpp, out_ptrs, len(raws),
                    self.n_threads,
                )
                if rc != 0:
                    raise FormatError("png: invalid filter type")
            else:
                from ..codecs.png.defilter import defilter

                for i, (_, raw) in enumerate(parsed):
                    outs[i] = defilter(raw, h, row_bytes, bpp)

        rows = self._shard(outs)
        fn = _jit(f"png_host_{cd}_{st0.width}_k{key_dev is not None}",
                  lambda r, p, key: _expand_graph(
                      cd, r, p, width=st0.width, key=key))
        return fn(rows, pal_dev, key_dev)
