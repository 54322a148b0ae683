"""Ragged-batch bucketing: decode a mixed corpus through ONE call.

SURVEY.md hard-part 4: images, scans, and rows have data-dependent
sizes, but every batched device graph wants same-shape inputs.  This
planner probes each encoded image's header (cheap, no pixel work),
groups the list into per-codec compatibility buckets, decodes each
bucket through its batched device decoder, and falls back to the host
decoder for anything a batched path doesn't cover — returning
per-input premultiplied RGBA8 [H, W, 4] arrays in input order (the
``rgba_pixels`` flatten, /root/reference/src/image/image.zig:103-130).

Bucket keys per codec:

* PNG  — (width, height, bit depth × color type, interlace): the
  layout contract of BatchPngDecoder.
* JPEG — (width, height, per-component sampling, progressive): the
  geometry BatchJpegDecoder stacks on.  Baseline (incl. 4-component
  CMYK/YCCK, whose batched planes get the Color.toRGBA cmyk arm
  applied) and progressive (OnchipProgressiveDecoder host-index
  split) both take device paths; only progressive 4-component streams
  host-route.
* QOI  — (width, height).
* BMP  — (width, height, orientation, bpp, header version).

A bucket whose batched decoder rejects its streams (``FormatError`` /
``UnsupportedError``) falls back to per-image host decode, so
``decode_mixed`` is total over every stream the host decoder accepts.
Any other error -- a device compile or runtime failure -- propagates.
"""

from __future__ import annotations

import struct

import numpy as np

from ..errors import FormatError, UnknownFormat, UnsupportedError

# ---------------------------------------------------------------------------
# Header probes — magic bytes + just enough structure for a bucket key.
# ---------------------------------------------------------------------------


def _probe_png(data: bytes):
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        return None
    # IHDR is required first (decoder.zig Stage machine); 8-byte chunk
    # header + 13-byte payload.
    if len(data) < 33 or data[12:16] != b"IHDR":
        return ("png", "host")
    w, h = struct.unpack(">II", data[16:24])
    depth, ctype, _, _, interlace = data[24:29]
    return ("png", w, h, depth, ctype, interlace)


def _probe_jpeg(data: bytes):
    if data[:2] != b"\xff\xd8":
        return None
    # Marker walk to the first SOF (decoder.zig:220-355 simplified to
    # length-skips; entropy data never precedes the first SOF).
    i = 2
    n = len(data)
    while i + 4 <= n:
        if data[i] != 0xFF:
            i += 1
            continue
        m = data[i + 1]
        if m in (0xD8, 0x01) or 0xD0 <= m <= 0xD7:
            i += 2
            continue
        if m == 0xFF:
            i += 1
            continue
        seglen = (data[i + 2] << 8) | data[i + 3]
        if m in (0xC0, 0xC1, 0xC2):  # SOF0/1/2
            p = i + 4
            if p + 6 > n:
                break
            h = (data[p + 1] << 8) | data[p + 2]
            w = (data[p + 3] << 8) | data[p + 4]
            ncomp = data[p + 5]
            hv = []
            q = p + 6
            for _ in range(ncomp):
                if q + 3 > n:
                    break
                hv.append(data[q + 1])
                q += 3
            return ("jpeg", w, h, ncomp, tuple(hv), m == 0xC2)
        i += 2 + seglen
    return ("jpeg", "host")  # undecodable header: let the host error


def _probe_qoi(data: bytes):
    if data[:4] != b"qoif" or len(data) < 14:
        return None
    w, h = struct.unpack(">II", data[4:12])
    return ("qoi", w, h)


def _probe_bmp(data: bytes):
    if data[:2] != b"BM":
        return None
    try:
        from ..codecs.bmp.decode import _read_header

        hh = _read_header(data)
        return ("bmp", hh[0], hh[1], hh[2], hh[3], hh[4])
    except Exception:
        return ("bmp", "host")


def probe_key(data: bytes):
    """Codec + compatibility bucket key for one encoded image."""
    for probe in (_probe_png, _probe_jpeg, _probe_qoi, _probe_bmp):
        key = probe(data)
        if key is not None:
            return key
    raise UnknownFormat("zpix: no codec matched the buffer")


def plan_buckets(buffers) -> dict:
    """Group buffer indices into compatibility buckets: key -> [idx]."""
    buckets: dict = {}
    for i, data in enumerate(buffers):
        buckets.setdefault(probe_key(data), []).append(i)
    return buckets


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def _host_rgba(data: bytes) -> np.ndarray:
    from .. import from_buffer

    img = from_buffer(data)
    return np.asarray(img.rgba_pixels(), np.uint8).reshape(
        img.height, img.width, 4
    )


def _to_rgba(out) -> np.ndarray:
    """Normalize a batched decoder output to [B, H, W, 4] RGBA8."""
    arr = np.asarray(out)
    if arr.ndim == 3:  # gray planes [B, H, W]
        a = np.full(arr.shape + (1,), 255, np.uint8)
        g = arr[..., None]
        return np.concatenate([g, g, g, a], axis=-1)
    if arr.shape[-1] == 3:  # RGB -> opaque RGBA
        a = np.full(arr.shape[:-1] + (1,), 255, np.uint8)
        return np.concatenate([arr, a], axis=-1)
    return arr


# Decoders whose compiled programs and layout hints live on the instance,
# kept per (bucket key, mesh) across decode_mixed calls so a repeated
# bucket reuses its program instead of tracing and compiling it again.
_DECODERS: dict = {}


def _cached_decoder(bucket_key, cls, mesh=None):
    key = (bucket_key, cls, mesh)
    dec = _DECODERS.get(key)
    if dec is None:
        dec = _DECODERS[key] = cls() if mesh is None else cls(mesh=mesh)
    return dec


def _decode_bucket(kind: str, key, datas: list[bytes], mesh, min_batch: int):
    """-> (rgba list, route) where route records which path decoded the
    bucket: 'device', 'host-small' (under min_batch), 'host-routed'
    (shapes a batched decoder doesn't cover), or 'host-error' (the batched
    decoder rejected the streams with a format error, or the progressive
    decoder's verification failed).  Other errors propagate."""
    if len(datas) < min_batch or "host" in key:
        return [_host_rgba(d) for d in datas], (
            "host-small" if "host" not in key else "host-routed"
        )
    try:
        if kind == "png":
            from .png_batch import BatchPngDecoder

            return list(_to_rgba(BatchPngDecoder(mesh=mesh).decode(datas))), \
                "device"
        if kind == "jpeg":
            ncomp, progressive = key[3], key[5]
            if progressive and ncomp == 4:
                # no batched path for progressive CMYK/YCCK
                return [_host_rgba(d) for d in datas], "host-routed"
            if progressive:
                # round-5 host-index split: C++ per-scan index passes +
                # small device value passes; ok=False (corrupt stream /
                # failed bit-exact verification) -> host decode
                from .progressive_onchip import OnchipProgressiveDecoder

                out, ok = _cached_decoder(
                    key, OnchipProgressiveDecoder).decode(datas)
                if bool(ok):
                    return list(_to_rgba(out)), "device"
                import logging

                logging.getLogger("zpix").warning(
                    "decode_mixed: progressive device decode failed "
                    "verification on a %d-image bucket (key=%r); host "
                    "fallback", len(datas), key,
                )
                return [_host_rgba(d) for d in datas], "host-error"
            from .batch import BatchJpegDecoder

            out = BatchJpegDecoder(mesh=mesh).decode(datas)
            if ncomp == 4:
                # batched YCCK/CMYK outputs the host CMYKImage's planes;
                # apply the Color.toRGBA cmyk arm (color.zig:115-121)
                from ..color import cmyk_to_rgba16

                arr = np.asarray(out)
                r, g, b = cmyk_to_rgba16(
                    arr[..., 0], arr[..., 1], arr[..., 2], arr[..., 3]
                )
                rgba = np.empty(arr.shape, np.uint8)
                rgba[..., 0] = r >> 8
                rgba[..., 1] = g >> 8
                rgba[..., 2] = b >> 8
                rgba[..., 3] = 255
                return list(rgba), "device"
            return list(_to_rgba(out)), "device"
        if kind == "qoi":
            # host-index split: the C++ lane pass + device expansion is
            # exact by construction (no ok flag) and the production
            # path — the speculative chip scan needs ~n_chunks fixed-
            # point rounds at scale (qoi_batch section comment)
            from .qoi_batch import HostIndexQoiDecoder

            rgba = _cached_decoder(key, HostIndexQoiDecoder, mesh).decode(
                datas)
            return list(np.asarray(rgba)), "device"
        if kind == "bmp":
            from .bmp_batch import BatchBmpDecoder

            return list(_to_rgba(BatchBmpDecoder(mesh=mesh).decode(datas))), \
                "device"
    except (FormatError, UnsupportedError):
        import logging

        logging.getLogger("zpix").exception(
            "decode_mixed: batched %s decoder rejected a %d-image bucket "
            "(key=%r); falling back to the host decoder", kind, len(datas),
            key,
        )
        return [_host_rgba(d) for d in datas], "host-error"
    return [_host_rgba(d) for d in datas], "host-routed"


def decode_mixed(buffers, *, mesh=None, min_batch: int = 1,
                 return_stats: bool = False):
    """Decode a mixed list of encoded images (any supported format,
    any geometry) -> list of RGBA8 [H, W, 4] arrays in input order.

    mesh: optional jax Mesh; compatible buckets shard on its 'batch'
    axis.  min_batch: buckets smaller than this skip the device path
    (avoids per-geometry compiles for one-off shapes).

    return_stats=True additionally returns {route: image count} so
    callers (and the regression tests) can assert eligible buckets
    actually took the device path; the same counts land in the
    utils.metrics registry as decode_mixed.<route>."""
    from ..utils import metrics

    buffers = list(buffers)
    results: list = [None] * len(buffers)
    stats: dict = {}
    for key, idxs in plan_buckets(buffers).items():
        outs, route = _decode_bucket(
            key[0], key, [buffers[i] for i in idxs], mesh, min_batch
        )
        stats[route] = stats.get(route, 0) + len(idxs)
        metrics.count(f"decode_mixed.{route}", len(idxs))
        for i, out in zip(idxs, outs):
            results[i] = np.asarray(out, np.uint8)
    if return_stats:
        return results, stats
    return results


def load_batch(paths, *, mesh=None, min_batch: int = 1):
    """decode_mixed over a list of file paths (one API call for a real
    directory: the planner handles mixed formats and geometries)."""
    bufs = []
    for p in paths:
        with open(p, "rb") as f:
            bufs.append(f.read())
    return decode_mixed(bufs, mesh=mesh, min_batch=min_batch)
