"""Batched + sharded decode on the virtual 8-device CPU mesh.

The single-host multi-device stand-in for a multi-device host (SURVEY.md
sec.4): batch sharding (dp) and block-row stripe sharding (the
sequence-parallel analog) must both produce bit-exact output vs the host
decoder.
"""

import os

import numpy as np
import pytest

from zpix.codecs import jpeg
from zpix.color import ycbcr_to_rgb8
from zpix.parallel import BatchJpegDecoder, make_mesh


@pytest.fixture(scope="module")
def jpeg_420(testdata):
    with open(os.path.join(testdata, "video-001.q50.420.jpeg"), "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def want_rgb(jpeg_420):
    img = jpeg.decode(jpeg_420)
    cb, cr = img.upsampled_cbcr()
    r, g, b = ycbcr_to_rgb8(img.y, cb, cr)
    return np.stack([r, g, b], axis=-1)


def test_batch_unsharded_parity(jpeg_420, want_rgb):
    out = np.asarray(BatchJpegDecoder().decode([jpeg_420] * 3))
    assert out.shape == (3, 103, 150, 3)
    for i in range(3):
        assert np.array_equal(out[i], want_rgb)


def test_batch_sharded_parity(jpeg_420, want_rgb):
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = make_mesh(jax.devices()[:8], batch=8, stripe=1)
    out = np.asarray(BatchJpegDecoder(mesh).decode([jpeg_420] * 8))
    for i in range(8):
        assert np.array_equal(out[i], want_rgb)


def test_batch_gray(testdata):
    with open(os.path.join(testdata, "video-005.gray.jpeg"), "rb") as f:
        data = f.read()
    host = jpeg.decode(data)
    out = np.asarray(BatchJpegDecoder().decode([data] * 2))
    assert np.array_equal(out[0], host.pix)


def test_mixed_shapes_rejected(jpeg_420, testdata):
    with open(os.path.join(testdata, "video-005.gray.jpeg"), "rb") as f:
        other = f.read()
    with pytest.raises(ValueError):
        BatchJpegDecoder().decode([jpeg_420, other])


def test_all_ratios_batch_parity(testdata):
    for ratio in ("410", "411", "420", "422", "440", "444"):
        with open(
            os.path.join(testdata, f"video-001.q50.{ratio}.jpeg"), "rb"
        ) as f:
            data = f.read()
        host = jpeg.decode(data)
        cb, cr = host.upsampled_cbcr()
        r, g, b = ycbcr_to_rgb8(host.y, cb, cr)
        want = np.stack([r, g, b], axis=-1)
        out = np.asarray(BatchJpegDecoder().decode([data]))
        assert np.array_equal(out[0], want), f"ratio {ratio}"


def test_batch_packed_parity(jpeg_420, want_rgb):
    """Sparse bitmap+values transfer must decode bit-identically."""
    out = np.asarray(BatchJpegDecoder(packed=True).decode([jpeg_420] * 3))
    for i in range(3):
        assert np.array_equal(out[i], want_rgb)


def test_pack_sparse_roundtrip(jpeg_420):
    from zpix.parallel.batch import pack_sparse, parse_coefficients

    fe = parse_coefficients(jpeg_420)
    for c in range(3):
        coeff = fe.coeffs[c]
        bitmap, vals = pack_sparse(coeff)
        nb = coeff.shape[0] * coeff.shape[1]
        flat = coeff.reshape(nb, 64)
        mask = np.unpackbits(bitmap, axis=1).astype(bool)
        assert np.array_equal(mask, flat != 0)
        assert np.array_equal(vals, flat[flat != 0].astype(np.int16))


def test_native_flat_batch_parity(jpeg_420, want_rgb):
    """Native whole-batch front-end + single-buffer transfer + device
    carve/unpack/permute must decode bit-identically."""
    from zpix import runtime
    from zpix.parallel.batch import (
        NativeBatchFrontEnd,
        decode_batch_ycbcr_flat,
    )

    if runtime.get_lib() is None:
        pytest.skip("native runtime unavailable")
    import jax

    B = 2
    fe = NativeBatchFrontEnd(jpeg_420, B, 2)
    fe.parse([jpeg_420] * B)
    q = [np.stack([fe.quants[c][0]] * B) for c in range(3)]
    by, bx = fe.myy * fe.hv[0][1], fe.mxx * fe.hv[0][0]
    cby, cbx = fe.myy * fe.hv[1][1], fe.mxx * fe.hv[1][0]
    out = np.asarray(
        decode_batch_ycbcr_flat(
            jax.device_put(fe.buffer), q[0], q[1], q[2],
            height=fe.height, width=fe.width, ratio=fe.ratio,
            by=by, bx=bx, cby=cby, cbx=cbx,
            layout=tuple(fe.layout), batch=B,
            perm_y=fe.perm_y, perm_c=fe.perm_c,
        )
    )
    for i in range(B):
        assert np.array_equal(out[i], want_rgb)


def test_parse_packed_native_corpus(testdata):
    """Native fused parse (stream order + perm) matches the Python
    front-end's grid-order coefficients on every baseline corpus file."""
    import glob

    from zpix import runtime
    from zpix.parallel.batch import parse_coefficients, parse_packed_native

    if runtime.get_lib() is None:
        pytest.skip("native runtime unavailable")
    checked = 0
    for path in sorted(glob.glob(os.path.join(testdata, "*.jpeg"))):
        with open(path, "rb") as f:
            data = f.read()
        p = parse_packed_native(data)
        if p is None:
            continue
        fe = parse_coefficients(data)
        for c in range(p.ncomp):
            flat = fe.coeffs[c].reshape(-1, 64)
            bits = np.unpackbits(p.bitmaps[c], axis=1)
            got = np.zeros_like(flat)
            got[bits.astype(bool)] = p.vals[c]
            if p.perms[c] is not None:
                got = got[p.perms[c]]
            assert np.array_equal(got, flat), (path, c)
        checked += 1
    assert checked >= 10


def test_restart_segment_parallel_decode(testdata):
    """Intra-image restart-segment parallel scan (the sequence-parallel
    analog) must produce byte-identical packed output."""
    from zpix import runtime
    from zpix.parallel.batch import parse_packed_native

    if runtime.get_lib() is None:
        pytest.skip("native runtime unavailable")
    with open(os.path.join(testdata, "video-001.restart2.jpeg"), "rb") as f:
        data = f.read()
    p1 = parse_packed_native(data, 1)
    p4 = parse_packed_native(data, 4)
    assert p1 is not None and p4 is not None
    for c in range(3):
        assert np.array_equal(p1.bitmaps[c], p4.bitmaps[c])
        assert np.array_equal(p1.vals[c], p4.vals[c])


def test_progressive_batched_decode(testdata):
    """Progressive streams flow through the batch pipeline (Python
    front-end + native per-SOS scans) bit-exactly."""
    from zpix.color import ycbcr_to_rgb8

    with open(
        os.path.join(testdata, "video-001.q50.420.progressive.jpeg"), "rb"
    ) as f:
        data = f.read()
    host = jpeg.decode(data)
    cb, cr = host.upsampled_cbcr()
    r, g, b = ycbcr_to_rgb8(host.y, cb, cr)
    want = np.stack([r, g, b], axis=-1)
    out = np.asarray(BatchJpegDecoder(packed=True).decode([data] * 2))
    assert np.array_equal(out[0], want)


PNG_BATCH_CASES = [
    ("tc8", "png/basn2c08.png"),
    ("tca8", "png/basn6a08.png"),
    ("g8", "png/basn0g08.png"),
    ("p8", "png/basn3p08.png"),
    ("g1", "png/basn0g01.png"),
    ("g2", "png/basn0g02.png"),
    ("g4", "png/basn0g04.png"),
    ("g16", "png/basn0g16.png"),
    ("tc16", "png/basn2c16.png"),
    ("tca16", "png/basn6a16.png"),
    ("ga8", "png/basn4a08.png"),
    ("ga16", "png/basn4a16.png"),
    ("p1", "png/basn3p01.png"),
    ("p2", "png/basn3p02.png"),
    ("p4", "png/basn3p04.png"),
    ("p8trns", "png/basn3p08-trns.png"),
    ("g1odd", "png/basn0g01-30.png"),
]


@pytest.mark.parametrize("depth,rel", PNG_BATCH_CASES)
def test_batch_png_parity(testdata, depth, rel):
    from zpix.codecs import png as png_codec
    from zpix.parallel.png_batch import BatchPngDecoder

    with open(os.path.join(testdata, rel), "rb") as f:
        data = f.read()
    host = png_codec.decode(data)
    out = np.asarray(BatchPngDecoder().decode([data] * 2))
    want = host.rgba_pixels().reshape(host.height, host.width, 4)
    assert np.array_equal(out[0], want)
    assert np.array_equal(out[1], want)


def test_batch_png_empty_batch(testdata):
    from zpix.parallel.png_batch import BatchPngDecoder

    with pytest.raises(ValueError, match="empty batch"):
        BatchPngDecoder().decode([])


def _mk_png(cd: str, pix: np.ndarray, trns: bytes | None = None) -> bytes:
    """Minimal PNG writer for color-key tests (filter 0 rows)."""
    import struct
    import zlib as _z

    depth = {"g4": 4, "g8": 8, "g16": 16, "tc8": 8, "tc16": 16}[cd]
    ctype = 0 if cd.startswith("g") else 2
    h = pix.shape[0]
    w = pix.shape[1]
    rows = bytearray()
    for y in range(h):
        rows.append(0)
        if cd == "g4":
            packed = bytearray()
            vals = list(pix[y])
            if len(vals) % 2:
                vals.append(0)
            for i in range(0, len(vals), 2):
                packed.append((vals[i] << 4) | vals[i + 1])
            rows += packed
        elif depth == 16:
            rows += pix[y].astype(">u2").tobytes()
        else:
            rows += pix[y].astype(np.uint8).tobytes()

    def chunk(tag, payload):
        c = struct.pack(">I", len(payload)) + tag + payload
        return c + struct.pack(">I", _z.crc32(tag + payload) & 0xFFFFFFFF)

    out = b"\x89PNG\r\n\x1a\n"
    out += chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0))
    if trns is not None:
        out += chunk(b"tRNS", trns)
    out += chunk(b"IDAT", _z.compress(bytes(rows)))
    out += chunk(b"IEND", b"")
    return out


def test_batch_png_colorkey_parity():
    """Gray/truecolor tRNS color keys through all three batched device
    front-ends, vs the golden-validated host decode (key scaling and
    16-bit pre-truncation compare semantics, decoder.zig:547-576).
    Batches mix keyed and unkeyed images to prove per-image keys."""
    from zpix import runtime
    from zpix.codecs import png as png_codec
    from zpix.parallel.png_batch import BatchPngDecoder

    rng = np.random.default_rng(7)
    cases = []
    g4 = rng.integers(0, 16, (9, 10), np.uint16)
    g4[2, :] = 7
    cases.append(("g4", g4, bytes([0, 7])))
    g8 = rng.integers(0, 256, (8, 8), np.uint16)
    g8[1, :] = 200
    cases.append(("g8", g8, bytes([0, 200])))
    g16 = rng.integers(0, 0x10000, (8, 8), np.uint16)
    g16[3, :] = 0x1234
    # 0x12EE truncates to the same 8-bit value but must stay opaque
    g16[4, :] = 0x12EE
    cases.append(("g16", g16, bytes([0x12, 0x34])))
    tc8 = rng.integers(0, 256, (8, 8, 3), np.uint16)
    tc8[2, 3] = (10, 20, 30)
    cases.append(("tc8", tc8, bytes([0, 10, 0, 20, 0, 30])))
    tc16 = rng.integers(0, 0x10000, (8, 8, 3), np.uint16)
    tc16[5, 1] = (0x0102, 0x0304, 0x0506)
    tc16[5, 2] = (0x0103, 0x0304, 0x0506)  # same high bytes, no match
    cases.append(
        ("tc16", tc16, bytes([0x01, 0x02, 0x03, 0x04, 0x05, 0x06]))
    )

    for cd, pix, trns in cases:
        keyed = _mk_png(cd, pix, trns)
        plain = _mk_png(cd, pix, None)
        host = png_codec.decode(keyed)
        want = host.rgba_pixels().reshape(host.height, host.width, 4)
        host_p = png_codec.decode(plain)
        want_p = host_p.rgba_pixels().reshape(want.shape)
        assert not np.array_equal(want, want_p), f"{cd}: key never matched"
        fronts = [dict(), dict(device_defilter=True)]
        if runtime.get_lib() is not None:
            fronts.append(dict(device_inflate=True))
        for kw in fronts:
            out = np.asarray(BatchPngDecoder(**kw).decode([keyed, plain]))
            assert np.array_equal(out[0], want), (cd, kw)
            assert np.array_equal(out[1], want_p), (cd, kw)


def test_dryrun_multichip():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "graft_entry",
        os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "__graft_entry__.py"),
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.dryrun_multichip(8)
    fn, args = mod.entry()
    import jax

    out = jax.jit(fn)(*args)
    assert out.shape[0] == args[0].shape[0]


@pytest.mark.parametrize("depth,rel", PNG_BATCH_CASES)
def test_batch_png_device_defilter_parity(testdata, depth, rel):
    """The on-chip wavefront defilter (ops/defilter.py) must reproduce
    the golden-validated host decode byte-for-byte on the full depth
    matrix (reference filter semantics decoder.zig:806-842)."""
    from zpix.codecs import png as png_codec
    from zpix.parallel.png_batch import BatchPngDecoder

    with open(os.path.join(testdata, rel), "rb") as f:
        data = f.read()
    host = png_codec.decode(data)
    out = np.asarray(BatchPngDecoder(device_defilter=True).decode([data] * 2))
    want = host.rgba_pixels().reshape(host.height, host.width, 4)
    assert np.array_equal(out[0], want)
    assert np.array_equal(out[1], want)


def test_batch_cmyk_ycck_rgb_parity(testdata):
    """4-component (YCCK/CMYK) and RGB JPEGs decode through the batched
    device back-end with host parity (applyBlack decoder.zig:792-902,
    convertToRGB :751-783).  Output channels mirror the host image pix."""
    import io

    from PIL import Image

    from zpix.codecs import jpeg as jpeg_codec
    from zpix.parallel.batch import BatchJpegDecoder

    cases = ["video-001.cmyk.jpeg"]
    datas = {}
    for name in cases:
        with open(os.path.join(testdata, name), "rb") as f:
            datas[name] = f.read()
    # PIL-generated raw CMYK (Adobe transform 0) as a second arm
    rgb = (np.arange(64 * 48 * 3) % 251).astype(np.uint8).reshape(48, 64, 3)
    buf = io.BytesIO()
    Image.fromarray(rgb).convert("CMYK").save(buf, format="JPEG", quality=80)
    datas["pil-cmyk"] = buf.getvalue()
    with open(os.path.join(testdata, "video-001.rgb.jpeg"), "rb") as f:
        datas["video-001.rgb.jpeg"] = f.read()

    for name, data in datas.items():
        host = jpeg_codec.decode(data)
        out = np.asarray(BatchJpegDecoder().decode([data] * 2))
        want = host.pix if out.shape[-1] == 4 else host.pix[..., :3]
        assert np.array_equal(out[0], want), name
        assert np.array_equal(out[1], want), name


def test_batch_png_interlaced_parity(testdata, png_dir):
    """Adam7 streams decode through the batched device path (per-pass
    wavefront defilter + expansion + strided device scatter) with host
    parity (mergePassInto, decoder.zig:1289-1373)."""
    import glob

    from zpix.codecs import png as png_codec
    from zpix.parallel.png_batch import BatchPngDecoder

    files = sorted(glob.glob(os.path.join(png_dir, "*i.png")))[:4]
    assert files, "no interlaced pngsuite files found"
    for path in files:
        with open(path, "rb") as f:
            data = f.read()
        host = png_codec.decode(data)
        out = np.asarray(BatchPngDecoder().decode([data] * 2))
        want = host.rgba_pixels().reshape(host.height, host.width, 4)
        assert np.array_equal(out[0], want), path
        assert np.array_equal(out[1], want), path


def test_decode_pipeline_overlap_parity():
    """The reusable overlapped pipeline (parallel/pipeline.py) yields
    exactly the per-batch decode results, in order."""
    from zpix.parallel.device_entropy import DeviceJpegDecoder
    from zpix.parallel.pipeline import (
        jpeg_onchip_pipeline,
        qoi_onchip_pipeline,
    )

    def synth(seed, w=96, h=64):
        import io

        from PIL import Image

        rng = np.random.RandomState(seed)
        base = rng.randint(0, 255, (h, w, 3)).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(base).save(buf, format="JPEG", quality=60,
                                   subsampling=2, restart_marker_blocks=4)
        return buf.getvalue()

    batches = [[synth(3 * s + j) for j in range(2)] for s in range(3)]
    dec = DeviceJpegDecoder()
    got = list(jpeg_onchip_pipeline(dec).map(batches))
    assert len(got) == 3
    for b, (out, ok) in zip(batches, got):
        ref, ok_ref = dec.decode(b)
        assert bool(ok) and bool(ok_ref)
        assert np.array_equal(np.asarray(out), np.asarray(ref))

    # QOI arm shares the same pipeline machinery
    from zpix.codecs.qoi.encode import Desc, encode

    rng = np.random.default_rng(5)
    imgs = [rng.integers(0, 256, (16, 24, 4), dtype=np.uint8) for _ in range(4)]
    qbatches = [[encode(a, Desc(24, 16, 4, 0)) for a in imgs[i : i + 2]]
                for i in (0, 2)]
    qgot = list(qoi_onchip_pipeline().map(qbatches))
    from zpix.codecs.qoi.decode import decode as qhost

    for b, (out, ok) in zip(qbatches, qgot):
        assert bool(ok)
        for i, d in enumerate(b):
            assert np.array_equal(np.asarray(out)[i], qhost(d).pix)


def test_batch_png_palette_overflow_parity():
    """Out-of-range palette indices resolve to auto-extended opaque
    black, matching the host (decoder.zig:1086-1130)."""
    import struct
    import zlib as _zlib

    from zpix.codecs import png as png_codec
    from zpix.parallel.png_batch import BatchPngDecoder

    def chunk(tag, payload):
        c = struct.pack(">I", len(payload)) + tag + payload
        return c + struct.pack(">I", _zlib.crc32(tag + payload) & 0xFFFFFFFF)

    w, h = 4, 2
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 3, 0, 0, 0)
    plte = bytes([255, 0, 0, 0, 255, 0])  # 2 entries; pixels go up to 5
    rows = b"".join(bytes([0]) + bytes([0, 1, 3, 5]) for _ in range(h))
    idat = _zlib.compress(rows)
    data = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"PLTE", plte)
        + chunk(b"IDAT", idat)
        + chunk(b"IEND", b"")
    )
    host = png_codec.decode(data)
    want = host.rgba_pixels().reshape(h, w, 4)
    assert tuple(want[0, 2]) == (0, 0, 0, 255)  # extended entry
    out = np.asarray(BatchPngDecoder().decode([data] * 2))
    assert np.array_equal(out[0], want) and np.array_equal(out[1], want)
    out = np.asarray(
        BatchPngDecoder(device_defilter=True).decode([data] * 2)
    )
    assert np.array_equal(out[0], want)


@pytest.mark.parametrize("depth,rel", PNG_BATCH_CASES)
def test_batch_png_device_inflate_parity(testdata, depth, rel):
    """Two-pass inflate: host DEFLATE symbol-resolve (runtime/inflate.cpp)
    + device LZ77 copy-resolve via pointer doubling (ops/inflate.py),
    fused with the wavefront defilter and expansion — byte parity with
    the golden-validated host decode (inflate semantics of
    std.compress.flate, decoder.zig:513-518)."""
    from zpix import runtime
    from zpix.codecs import png as png_codec
    from zpix.parallel.png_batch import BatchPngDecoder

    if runtime.get_lib() is None:
        pytest.skip("native runtime unavailable")
    with open(os.path.join(testdata, rel), "rb") as f:
        data = f.read()
    host = png_codec.decode(data)
    out = np.asarray(BatchPngDecoder(device_inflate=True).decode([data] * 2))
    want = host.rgba_pixels().reshape(host.height, host.width, 4)
    assert np.array_equal(out[0], want)
    assert np.array_equal(out[1], want)


def test_batch_png_device_inflate_interlaced(testdata, png_dir):
    """Adam7 through the fully-on-device front-end: copy-resolve ->
    per-pass defilter/expand -> strided scatter merge in one graph."""
    import glob

    from zpix import runtime
    from zpix.codecs import png as png_codec
    from zpix.parallel.png_batch import BatchPngDecoder

    if runtime.get_lib() is None:
        pytest.skip("native runtime unavailable")
    files = sorted(glob.glob(os.path.join(png_dir, "*i.png")))[:2]
    assert files, "no interlaced pngsuite files found"
    for path in files:
        with open(path, "rb") as f:
            data = f.read()
        host = png_codec.decode(data)
        out = np.asarray(
            BatchPngDecoder(device_inflate=True).decode([data] * 2)
        )
        want = host.rgba_pixels().reshape(host.height, host.width, 4)
        assert np.array_equal(out[0], want), path
        assert np.array_equal(out[1], want), path


def test_batch_png_device_inflate_sharded(testdata):
    """Token upload shards on the batch mesh axis; the vmapped resolve
    keeps every image's copy chains inside its own lane."""
    from zpix import runtime
    from zpix.codecs import png as png_codec
    from zpix.parallel.mesh import make_mesh
    from zpix.parallel.png_batch import BatchPngDecoder

    if runtime.get_lib() is None:
        pytest.skip("native runtime unavailable")
    import jax

    with open(os.path.join(testdata, "png/basn2c08.png"), "rb") as f:
        data = f.read()
    host = png_codec.decode(data)
    mesh = make_mesh(jax.devices()[:8], batch=8, stripe=1)
    out = np.asarray(
        BatchPngDecoder(mesh=mesh, device_inflate=True).decode([data] * 8)
    )
    want = host.rgba_pixels().reshape(host.height, host.width, 4)
    for i in range(8):
        assert np.array_equal(out[i], want)


def test_batch_png_rejects_mixed_interlace(png_dir):
    """Interlaced and non-interlaced images of identical dims must not
    mix in one batch: the layouts differ (per-pass row framing), so the
    compat check includes st.interlace (advisor finding, round 2)."""
    from io import BytesIO

    from PIL import Image

    from zpix.parallel.png_batch import BatchPngDecoder, _walk_idat

    with open(os.path.join(png_dir, "basn3p04-31i.png"), "rb") as f:
        inter = f.read()
    # Non-interlaced twin: same dims and p4 depth, interlace=0.
    img = Image.open(BytesIO(inter))
    buf = BytesIO()
    img.save(buf, format="PNG", bits=4)
    plain = buf.getvalue()
    st_i, st_p = _walk_idat(inter)[0], _walk_idat(plain)[0]
    assert (st_i.interlace, st_p.interlace) == (1, 0)
    assert (st_i.width, st_i.height, st_i.color_depth) == (
        st_p.width, st_p.height, st_p.color_depth,
    )
    with pytest.raises(ValueError, match="interlace"):
        BatchPngDecoder().decode([inter, plain])


def test_decode_mixed_corpus():
    """Ragged-batch bucketing (SURVEY hard-part 4): one API call over a
    mixed real-file corpus — formats, geometries, color depths, and
    progressive/baseline all in one list — parity per file against the
    host rgba_pixels flatten."""
    import glob

    import zpix
    from zpix.codecs.qoi.encode import Desc, encode
    from zpix.parallel.bucketing import load_batch, plan_buckets

    td = "/root/reference/src/testdata"
    paths = [
        os.path.join(td, "video-001.jpeg"),
        os.path.join(td, "video-001.progressive.jpeg"),
        os.path.join(td, "video-001.cmyk.jpeg"),
        os.path.join(td, "video-005.gray.jpeg"),
        os.path.join(td, "video-001.bmp"),
        os.path.join(td, "bmp_4bpp.bmp"),
        os.path.join(td, "png", "basn2c08.png"),
        os.path.join(td, "png", "basn6a08.png"),
        os.path.join(td, "png", "basn3p04-31i.png"),
        os.path.join(td, "png", "basn0g01-30.png"),
        # same-geometry pair: must land in ONE bucket
        os.path.join(td, "png", "basn2c16.png"),
        os.path.join(td, "png", "basn6a16.png"),
    ]
    bufs = []
    for p in paths:
        with open(p, "rb") as f:
            bufs.append(f.read())
    # one QOI leg (no .qoi files in the corpus): encode a decoded image
    img = zpix.load(paths[5])
    px = np.asarray(img.rgba_pixels(), np.uint8).reshape(
        img.height, img.width, 4
    )
    qoi_data = encode(px, Desc(img.width, img.height, 4, 0))
    bufs.append(qoi_data)

    buckets = plan_buckets(bufs)
    kinds = {k[0] for k in buckets}
    assert kinds == {"png", "jpeg", "bmp", "qoi"}

    from zpix.parallel.bucketing import decode_mixed

    outs, stats = decode_mixed(bufs[:-1], return_stats=True)
    assert load_batch(paths)[0].shape == outs[0].shape  # path API parity
    # EVERY bucket takes a device path (round-5: progressive routes
    # through the host-index OnchipProgressiveDecoder, 4-component
    # through the batched YCCK/CMYK graphs + toRGBA)
    assert stats == {"device": len(paths)}, stats
    qout, qstats = decode_mixed([qoi_data], return_stats=True)
    assert qstats.get("device", 0) == 1, qstats
    outs.append(qout[0])
    for p, out in zip(paths + ["<qoi>"], outs):
        data = bufs[(paths + ["<qoi>"]).index(p)]
        ref = zpix.from_buffer(data)
        want = np.asarray(ref.rgba_pixels(), np.uint8).reshape(
            ref.height, ref.width, 4
        )
        assert out.shape == want.shape, p
        assert np.array_equal(out, want), p


def test_decode_mixed_min_batch_host_fallback(png_dir):
    """min_batch > bucket size must route through the host decoder and
    still return identical pixels (no device compile for one-off shapes)."""
    import zpix
    from zpix.parallel.bucketing import decode_mixed

    with open(os.path.join(png_dir, "basn2c08.png"), "rb") as f:
        a = f.read()
    with open(os.path.join(png_dir, "basn0g04.png"), "rb") as f:
        b = f.read()
    outs, stats = decode_mixed([a, b], min_batch=3, return_stats=True)
    assert stats == {"host-small": 2}, stats  # no silent device attempts
    for data, out in zip((a, b), outs):
        img = zpix.from_buffer(data)
        want = np.asarray(img.rgba_pixels(), np.uint8).reshape(
            img.height, img.width, 4
        )
        assert np.array_equal(out, want)


def test_decode_mixed_broken_decoder_not_swallowed(monkeypatch, png_dir):
    """A batched decoder that raises must be VISIBLE (host-error route +
    logged) — regression guard for the round-3 silent `except: pass`."""
    import zpix
    from zpix.parallel import bucketing, png_batch

    class Boom:
        def __init__(self, **kw):
            pass

        def decode(self, datas):
            raise RuntimeError("deliberately broken batched decoder")

    monkeypatch.setattr(png_batch, "BatchPngDecoder", Boom)
    with open(os.path.join(png_dir, "basn2c08.png"), "rb") as f:
        a = f.read()
    outs, stats = bucketing.decode_mixed([a], return_stats=True)
    assert stats == {"host-error": 1}, stats
    img = zpix.from_buffer(a)
    want = np.asarray(img.rgba_pixels(), np.uint8).reshape(
        img.height, img.width, 4
    )
    assert np.array_equal(outs[0], want)


def test_roofline_cost_model_sanity():
    """The analytic cost model must scale with batch and produce the
    report lines the bench prints (SURVEY sec.5 accounting promise)."""
    from zpix.parallel.device_entropy import prep_batch
    from zpix.utils import roofline as rl

    from tools import corpus

    data = corpus.read("420_dri.jpg")
    p1 = prep_batch([data])
    p2 = prep_batch([data, data])
    c1 = rl.jpeg_onchip_costs(p1, k_syms=16, k1_syms=24, w_words=6,
                              w1_words=8, steps1=10, steps2=2)
    c2 = rl.jpeg_onchip_costs(p2, k_syms=16, k1_syms=24, w_words=6,
                              w1_words=8, steps1=10, steps2=2)
    for a, b in zip(c1, c2):
        assert b.bytes_moved > a.bytes_moved
        assert b.int_ops > a.int_ops
    rep = rl.report(c1, [1.0, 2.0, 3.0], "NVIDIA H100 80GB HBM3",
                    total_ms=6.0)
    assert "% HBM" in rep and "% INT32" in rep and "TOTAL" in rep
