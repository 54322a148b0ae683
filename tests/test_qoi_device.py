"""On-chip QOI decode (speculative chunk scan) differential tests.

The device kernel must be bit-exact versus the host decoder
(codecs/qoi/decode.py, itself differentially tested against the reference
semantics /root/reference/src/qoi/decoder.zig:20-130) over streams that
exercise every op and the stream-exhausted fill path.
"""

import numpy as np
import pytest

from zpix.codecs.qoi.decode import decode as host_decode
from zpix.codecs.qoi.encode import Desc, encode
from zpix.errors import UnsupportedError
from zpix.parallel.qoi_batch import BatchQoiDecoder, prep_qoi_batch


def _images(w=40, h=24, seed=0):
    """Gradient (DIFF/LUMA chains), flat (RUN caps), palette-ish (INDEX
    hits), and noise (RGB/RGBA literals) — every op class is exercised."""
    rng = np.random.default_rng(seed)
    grad = np.zeros((h, w, 4), np.uint8)
    grad[..., 3] = 255
    grad[..., :3] = (
        np.arange(w)[None, :, None] * 2 + np.arange(h)[:, None, None]
    ).astype(np.uint8)
    flat = np.full((h, w, 4), 77, np.uint8)
    pal = np.zeros((h, w, 4), np.uint8)
    lut = rng.integers(0, 256, (7, 4), dtype=np.uint8)
    pal[:] = lut[(np.arange(h * w) % 7)].reshape(h, w, 4)
    noise = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    return [grad, flat, pal, noise]


def _enc(img):
    h, w = img.shape[:2]
    return encode(img, Desc(w, h, 4, 0))


def test_device_qoi_parity():
    imgs = _images()
    datas = [_enc(a) for a in imgs]
    dec = BatchQoiDecoder(chunk_bytes=32, k_ops=2)
    out, ok = dec.decode(datas)
    assert bool(ok)
    out = np.asarray(out)
    for i, d in enumerate(datas):
        assert np.array_equal(out[i], host_decode(d).pix), f"image {i}"


def test_device_qoi_chunk_geometry_invariance():
    """Chunk size must not affect the decode (fixed point is exact)."""
    img = _images()[0]
    data = _enc(img)
    ref = host_decode(data).pix
    for cb in (16, 64, 256):
        out, ok = BatchQoiDecoder(chunk_bytes=cb).decode([data])
        assert bool(ok), f"chunk_bytes={cb}"
        assert np.array_equal(np.asarray(out)[0], ref), f"chunk_bytes={cb}"


def test_device_qoi_truncated_fill():
    """A truncated op stream must reproduce the host's fill-with-last-px
    tail (decoder.zig:67-69) — via ok=False fallback or exact device fill."""
    data = _enc(_images()[3])
    t = data[: len(data) // 2] + b"\x00" * 8
    ref = host_decode(t).pix
    out = BatchQoiDecoder(chunk_bytes=32).decode_verified([t])
    assert np.array_equal(out[0], ref)


def test_device_qoi_rejects_mixed_dims():
    a = _enc(np.zeros((8, 8, 4), np.uint8))
    b = _enc(np.zeros((8, 16, 4), np.uint8))
    with pytest.raises(UnsupportedError):
        prep_qoi_batch([a, b])


def test_device_qoi_mixed_stream_lengths():
    """Same dims, very different compressed sizes: trailing empty chunks
    must pass state through untouched."""
    imgs = [_images()[1], _images()[3]]  # flat (tiny stream) vs noise (big)
    datas = [_enc(a) for a in imgs]
    out, ok = BatchQoiDecoder(chunk_bytes=32).decode(datas)
    assert bool(ok)
    out = np.asarray(out)
    for i, d in enumerate(datas):
        assert np.array_equal(out[i], host_decode(d).pix), f"image {i}"


def test_device_qoi_ops_cap_overflow_exact():
    """An ops_cap below the true op count must flip ok to False (never
    emit wrong pixels), and decode_verified must stay parity-exact via
    the host fallback."""
    data = _enc(_images()[1])  # flat image: RUN ops, few per chunk
    dense = _enc(_images()[3])  # noise: ~1 op per 4-5 bytes
    ref = host_decode(dense).pix
    dec = BatchQoiDecoder(chunk_bytes=32, ops_cap=2)  # way under CB ops
    _, ok = dec.decode([dense])
    assert not bool(ok)
    assert np.array_equal(dec.decode_verified([dense])[0], ref)
    # a cap that genuinely covers the ops must keep the device path exact
    out, ok2 = BatchQoiDecoder(chunk_bytes=32, ops_cap=32).decode([data])
    assert bool(ok2)
    assert np.array_equal(np.asarray(out)[0], host_decode(data).pix)


def test_device_qoi_carry_guard():
    """The pre-dispatch guard must refuse a carry over the budget, and
    decode_verified must fall back to the host decoder instead of
    dispatching."""
    from zpix.parallel.qoi_batch import carry_bytes

    datas = [_enc(_images()[3])]
    plan = prep_qoi_batch(datas, 32)
    need = carry_bytes(plan)
    dec = BatchQoiDecoder(chunk_bytes=32, carry_mb=need / 2e6)
    with pytest.raises(UnsupportedError):
        dec.decode(datas)
    out = dec.decode_verified(datas)
    assert np.array_equal(out[0], host_decode(datas[0]).pix)


def test_encode_device_byte_identical():
    """On-device encoder must emit byte-identical streams to the serial
    emission (encoder.zig:29-132 semantics) over every op class, both
    channel counts, and the end-of-stream run flush."""
    from zpix.parallel.qoi_batch import encode_device

    rng = np.random.default_rng(7)
    h, w = 24, 40
    imgs = _images()
    # alpha variation (OP_RGBA) and a trailing run (tail flush)
    av = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    av[..., 3] = rng.integers(0, 3, (h, w)) * 127
    tr = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    tr[h // 2 :] = 9
    imgs += [av, tr]
    for i, img in enumerate(imgs):
        d = Desc(w, h, 4, 0)
        assert encode_device(img, d) == encode(img, d), f"image {i}"
    d3 = Desc(w, h, 3, 0)
    rgb = imgs[0][..., :3]
    assert encode_device(rgb, d3) == encode(rgb, d3)


def test_encode_device_batch_roundtrip():
    """vmapped batch encode: byte-identical per image, and the streams
    decode back to the input pixels (lossless roundtrip)."""
    from zpix.parallel.qoi_batch import encode_device_batch

    imgs = _images()
    h, w = imgs[0].shape[:2]
    descs = [Desc(w, h, 4, 0)] * len(imgs)
    outs = encode_device_batch(imgs, descs)
    for i, (img, data) in enumerate(zip(imgs, outs)):
        assert data == encode(img, descs[i]), f"image {i}"
        assert np.array_equal(host_decode(data).pix, img), f"image {i}"


def test_device_qoi_sharded_parity():
    """Lane state shards over the mesh batch axis (batch-major [B*F]
    flat lanes); the replicated stream + sharded per-image metadata
    must decode bit-identically to the host."""
    import jax

    from zpix.parallel.mesh import make_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    imgs = _images()
    datas = [_enc(imgs[i % len(imgs)]) for i in range(8)]
    mesh = make_mesh(jax.devices()[:8], batch=8, stripe=1)
    dec = BatchQoiDecoder(chunk_bytes=32, mesh=mesh)
    out, ok = dec.decode(datas)
    assert bool(ok)
    out = np.asarray(out)
    for i, d in enumerate(datas):
        assert np.array_equal(out[i], host_decode(d).pix), f"image {i}"


def test_encode_device_edge_sizes():
    """1-pixel images, exact 62-run caps, and 63-run remainders hit the
    encoder's flush edge cases (encoder.zig:88-95)."""
    from zpix.parallel.qoi_batch import encode_device

    cases = [
        np.full((1, 1, 4), 9, np.uint8),          # single pixel
        np.zeros((1, 1, 4), np.uint8),            # equals the implicit prev? no: a=0 != 255
        np.full((1, 62, 4), 7, np.uint8),         # run hits the 62 cap exactly
        np.full((1, 63, 4), 7, np.uint8),         # cap + 1 remainder
        np.full((1, 124, 4), 7, np.uint8),        # two full caps
    ]
    for i, img in enumerate(cases):
        h, w = img.shape[:2]
        d = Desc(w, h, 4, 0)
        got = encode_device(img, d)
        assert got == encode(img, d), f"case {i}"
        assert np.array_equal(host_decode(got).pix, img), f"case {i}"


# ---------------------------------------------------------------------------
# Host-index / device-expansion split (round 4): C++ record pass +
# device run-length expansion.  Exact by construction; these tests pin
# the record-pass semantics (native vs Python differential), the
# expansion graph, and the stream-exhausted fill.
# ---------------------------------------------------------------------------


def test_hostindex_qoi_parity():
    from zpix.parallel.qoi_batch import HostIndexQoiDecoder

    datas = [_enc(i) for i in _images()]
    out = np.asarray(HostIndexQoiDecoder().decode(datas))
    for i, d in enumerate(datas):
        assert np.array_equal(out[i], host_decode(d).pix), f"image {i}"


def test_hostindex_record_scan_native_vs_python():
    """The C++ and Python record scans must agree field-for-field
    (same rule as the JPEG native-vs-python scan differential)."""
    from zpix import runtime
    from zpix.parallel.qoi_batch import (
        _record_scan_native,
        _record_scan_py,
    )

    lib = runtime.get_lib()
    if lib is None or not hasattr(lib, "zpix_qoi_record_scan"):
        pytest.skip("native runtime unavailable")
    for img in _images():
        data = _enc(img)
        npx = img.shape[0] * img.shape[1]
        cn, nn, fn = _record_scan_native(data, npx)
        cp, np_, fp = _record_scan_py(data, npx)
        assert np.array_equal(cn, cp)
        assert np.array_equal(nn, np_)
        assert fn == fp


def test_record_scan_py_short_stream_matches_native():
    """A stream shorter than header+padding must raise FormatError in
    BOTH scans (native rc=1) — the Python twin may not IndexError or
    silently return (native-vs-python differential invariant)."""
    from zpix import runtime
    from zpix.errors import FormatError
    from zpix.parallel.qoi_batch import (
        _record_scan_native,
        _record_scan_py,
    )

    short = b"qoif" + b"\x00" * 10  # 14 bytes: header only, no padding
    with pytest.raises(FormatError):
        _record_scan_py(short, 16)
    lib = runtime.get_lib()
    if lib is not None and hasattr(lib, "zpix_qoi_record_scan"):
        with pytest.raises(FormatError):
            _record_scan_native(short, 16)


def test_lane_scan_py_rejects_int16_overflow_lane_p():
    """lane entries carry int16 local spans: P > 32767 must raise
    UnsupportedError (mirrors native rc=4), never silently wrap; and
    prep_qoi_lanes clamps an oversized P before dispatch."""
    from zpix.errors import UnsupportedError
    from zpix.parallel.qoi_batch import _lane_scan_py, prep_qoi_lanes

    data = _enc(_images()[0])
    with pytest.raises(UnsupportedError):
        _lane_scan_py(data, 64, 65536)
    plan = prep_qoi_lanes([data], P=65536)
    assert plan.P <= 32767  # clamped, then shrunk to a divisor of npx
    img = _images()[0]
    npx = img.shape[0] * img.shape[1]
    assert npx % plan.P == 0


def test_hostindex_p4_parity_and_half_bytes():
    """The packed (r,g,b,start) lane format must decode bit-identically
    to the wide form on opaque content, at HALF the staged bytes."""
    from zpix.parallel.qoi_batch import (
        HostIndexQoiDecoder,
        prep_qoi_lanes,
        prep_qoi_lanes4,
    )

    imgs = [i for i in _images() if np.all(i[..., 3] == 255)]
    assert imgs, "need opaque fixtures"
    datas = [_enc(i) for i in imgs[:1] * 3]
    p4 = prep_qoi_lanes4(datas, 16)
    wide = prep_qoi_lanes(datas, 16)
    assert p4 is not None and p4.fmt == "p4"
    assert p4.p4.nbytes * 2 <= wide.cols.nbytes + wide.s.nbytes + \
        wide.e.nbytes + 8  # 4 B/entry vs 8 (same R bucket)
    d_p4 = HostIndexQoiDecoder(lane_fmt="p4", lane_p=16)
    d_w = HostIndexQoiDecoder(lane_fmt="wide", lane_p=16)
    a = np.asarray(d_p4.decode(datas))
    b = np.asarray(d_w.decode(datas))
    assert np.array_equal(a, b)
    assert np.array_equal(a[0], host_decode(datas[0]).pix)


def test_hostindex_p4_auto_falls_back_on_alpha():
    """lane_fmt='auto' must fall back to the wide form (exactly, not
    wrongly) when the stream carries non-opaque colors."""
    from zpix.parallel.qoi_batch import (
        HostIndexQoiDecoder,
        prep_qoi_lanes4,
    )

    rng = np.random.RandomState(7)
    img = rng.randint(0, 256, (16, 16, 4), np.uint8)  # alpha varies
    data = _enc(img)
    assert prep_qoi_lanes4([data], 16) is None
    dec = HostIndexQoiDecoder(lane_fmt="auto", lane_p=16)
    out = np.asarray(dec.decode([data]))
    assert np.array_equal(out[0], host_decode(data).pix)
    with pytest.raises(Exception):
        HostIndexQoiDecoder(lane_fmt="p4", lane_p=16).decode([data])


def test_hostindex_p4_native_vs_python():
    """The C++ fill4 and the Python assembly must produce identical
    packed arrays (native-vs-python differential invariant)."""
    from zpix import runtime
    from zpix.parallel.qoi_batch import _lane_scan_py, prep_qoi_lanes4

    lib = runtime.get_lib()
    if lib is None or not hasattr(lib, "zpix_qoi_lane_fill4"):
        pytest.skip("native runtime unavailable")
    img = next(i for i in _images() if np.all(i[..., 3] == 255))
    data = _enc(img)
    npx = img.shape[0] * img.shape[1]
    P = 16 if npx % 16 == 0 else 8
    plan = prep_qoi_lanes4([data], P)
    assert plan is not None
    n_lanes = npx // plan.P
    cols, ls, _le, lane = _lane_scan_py(data, npx, plan.P)
    want = np.zeros((n_lanes, plan.R, 4), np.uint8)
    want[:, :, 3] = plan.P
    cnt = np.bincount(lane, minlength=n_lanes)
    first = np.cumsum(cnt) - cnt
    slot = np.arange(len(cols)) - first[lane]
    want[lane, slot, 0] = (cols >> 24).astype(np.uint8)
    want[lane, slot, 1] = ((cols >> 16) & 0xFF).astype(np.uint8)
    want[lane, slot, 2] = ((cols >> 8) & 0xFF).astype(np.uint8)
    want[lane, slot, 3] = ls.astype(np.uint8)
    assert np.array_equal(plan.p4.reshape(n_lanes, plan.R, 4), want)


def test_hostindex_qoi_truncated_fill():
    """Stream exhausts early -> remaining pixels replicate the final
    decoder px (decoder.zig:67-69), applied as the device fill color."""
    from zpix.parallel.qoi_batch import HostIndexQoiDecoder

    data = _enc(_images()[3])
    t = data[: len(data) // 2] + b"\x00" * 8
    ref = host_decode(t).pix
    out = np.asarray(HostIndexQoiDecoder().decode([t]))
    assert np.array_equal(out[0], ref)


def test_hostindex_qoi_run_clip_at_pixel_count():
    """A RUN op crossing pixel_count is clipped exactly (the reference's
    per-pixel loop just stops; record counts must not overrun)."""
    from zpix.parallel.qoi_batch import HostIndexQoiDecoder

    img = np.full((6, 11, 4), 200, np.uint8)  # 66 px: 62-run + 4-run
    data = _enc(img)
    out = np.asarray(HostIndexQoiDecoder().decode([data]))
    assert np.array_equal(out[0], host_decode(data).pix)


def test_hostindex_qoi_shared_layout_cache():
    """Different batches reuse one compiled expansion program when the
    record cap buckets to the same layout."""
    from zpix.parallel.qoi_batch import HostIndexQoiDecoder

    dec = HostIndexQoiDecoder()
    imgs = _images()
    _ = dec.decode([_enc(imgs[0]), _enc(imgs[1])])
    _ = dec.decode([_enc(imgs[2]), _enc(imgs[3])])
    assert len(dec._fns) == 1, "layout bucketing failed to share programs"


def test_hostindex_qoi_sharded_parity():
    import jax

    from zpix.parallel.mesh import make_mesh
    from zpix.parallel.qoi_batch import HostIndexQoiDecoder

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    imgs = _images()
    datas = [_enc(imgs[i % len(imgs)]) for i in range(8)]
    mesh = make_mesh(jax.devices()[:8], batch=8, stripe=1)
    out = np.asarray(HostIndexQoiDecoder(mesh=mesh).decode(datas))
    for i, d in enumerate(datas):
        assert np.array_equal(out[i], host_decode(d).pix), f"image {i}"


def test_lane_scan_native_vs_python():
    """C++ vs Python lane-entry scans agree field-for-field at several
    lane widths (the lane split is the gather-free expansion format)."""
    from zpix import runtime
    from zpix.parallel.qoi_batch import _lane_scan_native, _lane_scan_py

    lib = runtime.get_lib()
    if lib is None or not hasattr(lib, "zpix_qoi_lane_scan"):
        pytest.skip("native runtime unavailable")
    for img in _images():
        data = _enc(img)
        npx = img.shape[0] * img.shape[1]
        for P in (8, 16, 48):
            a = _lane_scan_native(data, npx, P)
            b = _lane_scan_py(data, npx, P)
            for x, y in zip(a, b):
                assert np.array_equal(x, y), P


def test_hostindex_lane_parity_and_widths():
    """Lane expansion (gather-free compare-mask) is bit-exact across
    lane widths, including a truncated stream's fill tail."""
    from zpix.parallel.qoi_batch import HostIndexQoiDecoder

    datas = [_enc(i) for i in _images()]  # 40x24 = 960 px
    ref = np.stack([host_decode(d).pix for d in datas])
    for P in (8, 16, 32, 60):  # 960 % P == 0 for all
        out = np.asarray(HostIndexQoiDecoder(lane_p=P).decode(datas))
        assert np.array_equal(out, ref), P
    t = datas[3][: len(datas[3]) // 2] + b"\x00" * 8
    out = np.asarray(HostIndexQoiDecoder(lane_p=16).decode([t]))
    assert np.array_equal(out[0], host_decode(t).pix)


def test_hostindex_lane_nondivisor_width_autoshrinks():
    """A lane width that does not divide the pixel count shrinks to the
    largest divisor (layout must tile the raster exactly)."""
    from zpix.parallel.qoi_batch import prep_qoi_lanes

    data = _enc(_images()[0])  # 960 px
    plan = prep_qoi_lanes([data], P=7)
    assert plan.P == 6 and 960 % plan.P == 0


def test_hostindex_lane_sharded_parity():
    import jax

    from zpix.parallel.mesh import make_mesh
    from zpix.parallel.qoi_batch import HostIndexQoiDecoder

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    imgs = _images()
    datas = [_enc(imgs[i % len(imgs)]) for i in range(8)]
    mesh = make_mesh(jax.devices()[:8], batch=8, stripe=1)
    out = np.asarray(
        HostIndexQoiDecoder(mesh=mesh, lane_p=16).decode(datas)
    )
    for i, d in enumerate(datas):
        assert np.array_equal(out[i], host_decode(d).pix), f"image {i}"
