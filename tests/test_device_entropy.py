"""On-chip JPEG entropy decode (restart-segment lanes) differential tests.

The device kernel must reproduce the host front-end's coefficients exactly
(reference entropy semantics: /root/reference/src/jpeg/decoder.zig:1294-1454)
and the full device pipeline must match the host-front-end batch decoder
pixel-for-pixel.
"""

import os

import numpy as np
import pytest

from zpix.errors import UnsupportedError
from zpix.parallel.batch import BatchJpegDecoder, parse_coefficients
from zpix.parallel.device_entropy import (
    DeviceJpegDecoder,
    coefficients_to_grids,
    prep_batch,
)


@pytest.fixture(scope="module")
def restart_jpeg(testdata):
    with open(os.path.join(testdata, "video-001.restart2.jpeg"), "rb") as f:
        return f.read()


def test_coefficient_parity(restart_jpeg):
    plan = prep_batch([restart_jpeg, restart_jpeg])
    assert (plan.width, plan.height, plan.ratio) == (150, 103, "420")
    dec = DeviceJpegDecoder()
    coeffs, ok = dec.decode_coefficients(plan)
    assert bool(ok)
    grids = coefficients_to_grids(plan, coeffs)
    ref = parse_coefficients(restart_jpeg)
    for c in range(plan.ncomp):
        for b in range(plan.batch):
            assert np.array_equal(np.asarray(grids[c][b]), ref.coeffs[c]), (
                f"component {c} image {b} coefficients differ"
            )


def test_pixel_parity(restart_jpeg):
    dec = DeviceJpegDecoder()
    img, ok = dec.decode([restart_jpeg, restart_jpeg])
    assert bool(ok)
    ref = np.asarray(BatchJpegDecoder().decode([restart_jpeg, restart_jpeg]))
    assert np.array_equal(np.asarray(img), ref)


def test_requires_restart_markers(testdata):
    with open(os.path.join(testdata, "video-001.jpeg"), "rb") as f:
        data = f.read()
    with pytest.raises(UnsupportedError):
        prep_batch([data])


def test_rejects_progressive(testdata):
    with open(os.path.join(testdata, "video-001.progressive.jpeg"), "rb") as f:
        data = f.read()
    with pytest.raises(UnsupportedError):
        prep_batch([data])


def test_rejects_mixed_batch(restart_jpeg, testdata):
    with open(os.path.join(testdata, "video-001.jpeg"), "rb") as f:
        other = f.read()
    with pytest.raises(UnsupportedError):
        prep_batch([restart_jpeg, other])


def _synth_jpeg(w=200, h=120, mode="420", dri_blocks=5, phase=0.0):
    """Structured synthetic JPEG with restart markers via Pillow."""
    import io

    from PIL import Image

    x = np.linspace(0, 17, w)
    y = np.linspace(0, 13, h)
    base = (128 + 100 * np.sin(x[None, :] * np.cos(y[:, None]) + phase)).astype(
        np.uint8
    )
    sub = {"gray": 0, "444": 0, "422": 1, "420": 2}[mode]
    if mode == "gray":
        img = Image.fromarray(base, "L")
    else:
        img = Image.fromarray(np.stack([base, base[::-1], base // 2 + 32], -1))
    buf = io.BytesIO()
    img.save(buf, format="JPEG", quality=60, subsampling=sub,
             restart_marker_blocks=dri_blocks)
    return buf.getvalue()


@pytest.mark.parametrize(
    "mode",
    ["gray", pytest.param("444", marks=pytest.mark.slow),
     pytest.param("422", marks=pytest.mark.slow), "420"],
)
def test_ratio_matrix_parity(mode):
    """Every supported subsampling + gray decodes bit-exactly on-device,
    including non-square dims and a partial final restart segment."""
    data = _synth_jpeg(mode=mode)
    dec = DeviceJpegDecoder()
    out, ok = dec.decode([data, data])
    assert bool(ok)
    ref = np.asarray(BatchJpegDecoder().decode([data]))
    out = np.asarray(out)
    assert np.array_equal(out[0], ref[0]) and np.array_equal(out[1], ref[0])


@pytest.mark.slow
def test_mesh_sharded_decode_parity():
    """Segment lanes shard over the mesh batch axis; output must be
    bit-identical to the unsharded path on the virtual 8-device mesh."""
    from zpix.parallel import make_mesh

    data = _synth_jpeg(w=256, h=128)
    datas = [data] * 8
    mesh = make_mesh()
    sharded = DeviceJpegDecoder(mesh=mesh)
    plain = DeviceJpegDecoder()
    out_s, ok_s = sharded.decode(datas)
    out_p, ok_p = plain.decode(datas)
    assert bool(ok_s) and bool(ok_p)
    assert np.array_equal(np.asarray(out_s), np.asarray(out_p))


def test_mesh_lane_mismatch_raises():
    from zpix.parallel import make_mesh

    data = _synth_jpeg(w=40, h=24)  # few segments
    mesh = make_mesh()
    plan = prep_batch([data])
    if (plan.batch * plan.n_segs) % mesh.shape["batch"] == 0:
        pytest.skip("lane count happens to divide the mesh")
    with pytest.raises(ValueError):
        DeviceJpegDecoder(mesh=mesh).decode_coefficients(plan)


@pytest.mark.slow
def test_corrupt_stream_flags_not_ok():
    """Flipping entropy bytes must trip the integrity check (ok=False) or
    raise at destuff time - never return silently wrong pixels as ok."""
    data = bytearray(_synth_jpeg())
    # corrupt a run of bytes well inside the scan body
    tail = len(data) - 600
    for i in range(tail, tail + 40):
        data[i] ^= 0x55
    dec = DeviceJpegDecoder()
    try:
        out, ok = dec.decode([bytes(data)])
    except Exception:
        return  # destuff rejected the stream: acceptable
    ref, ok_ref = dec.decode([_synth_jpeg()])
    if bool(ok):  # corruption happened to stay decodable as valid codes
        assert not np.array_equal(np.asarray(out), np.asarray(ref))
    else:
        assert not bool(ok)


@pytest.mark.slow
def test_huge_restart_interval():
    """The pass-1 step ceiling is derived from the longest segment, so a
    large-DRI dense image must still decode (found by review: a fixed
    16384-step cap failed segments over ~130k symbols)."""
    import io

    from PIL import Image

    x = np.linspace(0, 40, 1024)
    base = (128 + 100 * np.sin(x[None, :] * np.cos(x[:, None]))).astype(np.uint8)
    rgb = np.stack([base, base.T, base // 2], -1)
    buf = io.BytesIO()
    Image.fromarray(rgb).save(
        buf, format="JPEG", quality=90, subsampling=2, restart_marker_rows=16
    )
    data = buf.getvalue()
    img, ok = DeviceJpegDecoder().decode([data])
    assert bool(ok)
    ref = np.asarray(BatchJpegDecoder().decode([data]))
    assert np.array_equal(np.asarray(img)[0], ref[0])


@pytest.mark.slow
def test_production_unroll_config(restart_jpeg):
    """The wide production unrolls (k=12/k1=16, pass-1 window 8 words)
    must decode identically to the test-default narrow unrolls — the
    conftest dials the env defaults down for XLA:CPU compile speed, so
    this covers the shipped config explicitly on a small image."""
    dec = DeviceJpegDecoder(k_syms=12, k1_syms=16, win_words=4, win1_words=8)
    img, ok = dec.decode([restart_jpeg])
    assert bool(ok)
    ref = np.asarray(BatchJpegDecoder().decode([restart_jpeg]))
    assert np.array_equal(np.asarray(img)[0], ref[0])


def test_mesh_packed_decode_parity():
    """The single-buffer (packed) upload must compose with the mesh:
    per-device [stream ++ local offsets] rows under shard_map, bit-equal
    to both the unsharded packed path and the 3-array mesh path."""
    from zpix.parallel import make_mesh

    data = _synth_jpeg(w=256, h=128)
    datas = [data] * 8
    mesh = make_mesh()
    packed = DeviceJpegDecoder(mesh=mesh, packed=True)
    plain = DeviceJpegDecoder()
    out_p, ok_p = packed.decode(datas)
    out_u, ok_u = plain.decode(datas)
    assert bool(ok_p) and bool(ok_u)
    assert np.array_equal(np.asarray(out_p), np.asarray(out_u))


def _synth_cmyk(transform=None, w=96, h=80):
    """PIL CMYK JPEG with restarts; transform patches the Adobe APP14
    transform byte (0=raw CMYK, 2=YCCK) so both decode arms are testable
    from one entropy stream."""
    import io

    from PIL import Image

    rgb = (np.arange(w * h * 3) % 253).astype(np.uint8).reshape(h, w, 3)
    buf = io.BytesIO()
    Image.fromarray(rgb).convert("CMYK").save(
        buf, format="JPEG", quality=75, restart_marker_blocks=4
    )
    data = bytearray(buf.getvalue())
    if transform is not None:
        at = data.find(b"Adobe")
        assert at > 0, "PIL CMYK JPEG should carry an Adobe APP14 marker"
        data[at + 11] = transform  # decoder.zig:682-697 reads body[11]
    return bytes(data)


@pytest.mark.parametrize("transform,label", [(None, "cmyk"), (2, "ycck")])
def test_onchip_cmyk_ycck_parity(transform, label):
    """4-component frames decode fully on-chip with host parity through
    both applyBlack arms (decoder.zig:792-902)."""
    import zpix.codecs.jpeg as jpeg_codec

    data = _synth_cmyk(transform)
    from zpix.parallel.batch import parse_coefficients

    assert parse_coefficients(data).color == label
    out, ok = DeviceJpegDecoder().decode([data, data])
    assert bool(ok)
    host = jpeg_codec.decode(data)
    out = np.asarray(out)
    assert np.array_equal(out[0], host.pix), label
    assert np.array_equal(out[1], host.pix), label


def test_onchip_rgb_parity():
    """RGB-colorspace JPEG (convertToRGB, decoder.zig:751-783) on-chip."""
    import io

    import zpix.codecs.jpeg as jpeg_codec
    from PIL import Image

    rgb = (np.arange(96 * 80 * 3) % 253).astype(np.uint8).reshape(80, 96, 3)
    buf = io.BytesIO()
    Image.fromarray(rgb).save(
        buf, format="JPEG", quality=75, keep_rgb=True,
        restart_marker_blocks=4, subsampling=0,
    )
    data = buf.getvalue()
    out, ok = DeviceJpegDecoder().decode([data])
    assert bool(ok)
    host = jpeg_codec.decode(data)
    assert np.array_equal(np.asarray(out)[0], host.pix[..., :3])


def test_pass1_bins_parity():
    """bins>1 runs pass 1 over length-sorted lane groups via a data-level
    permutation; the un-permute must round-trip exactly (pixel-identical
    to the single-loop form), including a partial final restart segment
    and distinct per-image segment lengths."""
    datas = [_synth_jpeg(phase=p) for p in (0.0, 1.3, 2.6)]
    ref, ok0 = DeviceJpegDecoder().decode(datas)
    assert bool(ok0)
    for bins in (2, 8):  # 8 does not divide the 63 lanes: uneven slices
        out, ok1 = DeviceJpegDecoder(bins=bins).decode(datas)
        assert bool(ok1), f"bins={bins}"
        assert np.array_equal(np.asarray(ref), np.asarray(out)), f"bins={bins}"


def test_host_index_restart_free_parity(testdata):
    """Restart-free streams (the case where speculative sync is provably
    serial): host C++ index pass + device value pass must reproduce the
    host batch decoder exactly, including the pass-2 offset verification."""
    from zpix.parallel.device_entropy import HostIndexJpegDecoder

    with open(os.path.join(testdata, "video-001.jpeg"), "rb") as f:
        data = f.read()
    dec = HostIndexJpegDecoder()
    out, ok = dec.decode([data, data])
    assert bool(ok)
    ref = np.asarray(BatchJpegDecoder().decode([data, data]))
    assert np.array_equal(np.asarray(out), ref)


def test_host_index_rejects_restart_streams(restart_jpeg):
    from zpix.parallel.device_entropy import prep_batch_host_index

    with pytest.raises(UnsupportedError):
        prep_batch_host_index([restart_jpeg])


def test_i16_stores_parity(restart_jpeg):
    """The int16 value-pass store (split DC row) and int16 relative
    pass-1 ends must decode bit-identically to the int32 forms — the
    narrowings are exact by range analysis (AC extend <= 15 bits;
    segment-relative ends < 2^15 under the auto-gate)."""
    ref, ok0 = DeviceJpegDecoder().decode([restart_jpeg, restart_jpeg])
    out, ok1 = DeviceJpegDecoder(i16=True, p1_i16=True).decode(
        [restart_jpeg, restart_jpeg]
    )
    assert bool(ok0) and bool(ok1)
    assert np.array_equal(np.asarray(ref), np.asarray(out))
