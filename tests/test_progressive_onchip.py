"""On-chip progressive entropy decode differentials.

The device decodes every DC-first / AC-first / DC-refine scan
(speculative chunk fixed point, progressive_onchip.py); AC refinements
use the host-INDEX/device-VALUE split (C++ bit-offset pass + mask-
parallel device apply), with the host tail as fallback for nonstandard
scripts.  Output must be bit-exact with the host decoder (itself
parity-tested against the reference semantics, decoder.zig:1362-1549)
over the progressive corpus.
"""

import glob
import os

import numpy as np
import pytest

from zpix.codecs.jpeg import decoder as host
from zpix.color import ycbcr_to_rgb8
from zpix.parallel.progressive_onchip import (
    OnchipProgressiveDecoder,
    parse_progressive,
)

_KW = dict(chunk_bytes=16, k1=4, k2=4, W=4)  # small unrolls for XLA:CPU


def _want(data):
    img = host.decode(data)
    if img.__class__.__name__ == "GrayImage":
        return img.pix
    cb, cr = img.upsampled_cbcr()
    r, g, b = ycbcr_to_rgb8(img.y, cb, cr)
    return np.stack([r, g, b], axis=-1)


def _run(path, dec=None):
    with open(path, "rb") as f:
        data = f.read()
    dec = dec or OnchipProgressiveDecoder(**_KW)
    out, ok = dec.decode([data, data])
    assert bool(ok), path
    want = _want(data)
    got = np.asarray(out)
    assert np.array_equal(got[0], want), path
    assert np.array_equal(got[1], want), path


FAST_FILES = [
    "video-001.q50.444.progressive.jpeg",  # standard libjpeg script
    "video-005.gray.q50.2x2.progressive.jpeg",  # gray, declared 2x2
    "video-001.separate.dc.progression.progressive.jpeg",  # split DC scans
]


@pytest.mark.parametrize("name", FAST_FILES)
def test_onchip_progressive_parity(testdata, name):
    _run(os.path.join(testdata, name))


def test_onchip_prefix_covers_spectral_scans(testdata):
    """The standard script's whole spectral pass (DC first + 4 AC first)
    must be device-decodable — zero host Huffman before the first AC
    refinement."""
    with open(
        os.path.join(testdata, "video-001.q50.444.progressive.jpeg"), "rb"
    ) as f:
        pp = parse_progressive(f.read())
    kinds = [s.kind for s in pp.scans]
    first_refine = kinds.index("ac_refine")
    assert first_refine >= 5
    assert all(k in ("dc_first", "ac_first") for k in kinds[:first_refine])


def test_onchip_ac_refine_zero_host_tail(testdata):
    """The AC-refinement index/value split must cover the WHOLE standard
    scan script on device: zero host-tail scans, pixels exact."""
    path = os.path.join(testdata, "video-001.q50.444.progressive.jpeg")
    with open(path, "rb") as f:
        data = f.read()
    dec = OnchipProgressiveDecoder(**_KW)
    out, ok = dec.decode([data, data])
    assert dec.n_host_tail_scans == 0, (
        f"{dec.n_host_tail_scans} scans fell back to the host tail"
    )
    assert bool(ok)
    want = _want(data)
    got = np.asarray(out)
    assert np.array_equal(got[0], want) and np.array_equal(got[1], want)


def test_onchip_ac_refine_gray_zero_host_tail(testdata):
    """Gray progressive: single-component refinements through the split."""
    path = os.path.join(testdata, "video-005.gray.q50.progressive.jpeg")
    if not os.path.exists(path):
        pytest.skip("corpus file missing")
    with open(path, "rb") as f:
        data = f.read()
    dec = OnchipProgressiveDecoder(**_KW)
    out, ok = dec.decode([data])
    assert dec.n_host_tail_scans == 0
    assert bool(ok)
    assert np.array_equal(np.asarray(out)[0], _want(data))


def test_onchip_progressive_max_batch_splits(testdata):
    """Batches over max_batch split into equal-shaped sub-batches —
    output identical to one-shot."""
    path = os.path.join(testdata, "video-001.q50.444.progressive.jpeg")
    with open(path, "rb") as f:
        data = f.read()
    dec = OnchipProgressiveDecoder(**_KW, max_batch=2)
    out, ok = dec.decode([data, data, data])  # 2 + 1 sub-batches
    assert bool(ok)
    want = _want(data)
    got = np.asarray(out)
    assert got.shape[0] == 3
    for i in range(3):
        assert np.array_equal(got[i], want)


def test_onchip_progressive_hostindex_vs_spec_parity(testdata):
    """The round-5 host-index first-scan split and the speculative
    chunk path must produce identical pixels, both ok=True."""
    path = os.path.join(testdata, "video-001.q50.444.progressive.jpeg")
    with open(path, "rb") as f:
        data = f.read()
    d_hi = OnchipProgressiveDecoder(**_KW, impl="hostindex")
    d_sp = OnchipProgressiveDecoder(**_KW, impl="spec")
    o1, ok1 = d_hi.decode([data])
    o2, ok2 = d_sp.decode([data])
    assert bool(ok1) and bool(ok2)
    assert d_hi.n_host_tail_scans == 0
    assert np.array_equal(np.asarray(o1), np.asarray(o2))


def test_hostindex_prep_repeat_stress(testdata):
    """Regression for the ensure_lut16 thread race: repeated preps with
    the shared worker pool hit a half-built LUT16 about 1-in-4 before
    the C++ mutex fix (spurious ERR_BAD_HUFFMAN -> prep None)."""
    from zpix import runtime
    from zpix.parallel.progressive_onchip import parse_progressive

    if runtime.get_lib() is None:
        pytest.skip("native runtime unavailable")
    path = os.path.join(testdata, "video-001.q50.444.progressive.jpeg")
    with open(path, "rb") as f:
        data = f.read()
    dec = OnchipProgressiveDecoder(**_KW)
    plans = [parse_progressive(data) for _ in range(8)]
    dec._check_batch(plans)
    for i in range(6):
        assert dec._prep_hostindex(plans) is not None, f"prep {i} failed"


@pytest.mark.slow
def test_onchip_progressive_full_corpus(testdata):
    dec = OnchipProgressiveDecoder(**_KW)
    files = sorted(glob.glob(os.path.join(testdata, "*progressive*.jpeg")))
    assert len(files) >= 9
    for path in files:
        _run(path, dec)


def test_onchip_progressive_rejects_baseline(testdata):
    from zpix.errors import UnsupportedError

    with open(os.path.join(testdata, "video-001.jpeg"), "rb") as f:
        data = f.read()
    with pytest.raises(UnsupportedError):
        parse_progressive(data)


def test_onchip_progressive_corrupt_falls_back(testdata):
    """A corrupted scan body must fail the exact verification (ok=False)
    and decode_verified must return the host decoder's result for the
    same stream — never silently wrong pixels."""
    path = os.path.join(testdata, "video-001.q50.444.progressive.jpeg")
    with open(path, "rb") as f:
        data = bytearray(f.read())
    # flip bits inside the FIRST scan's entropy data (after the first SOS)
    sos = data.find(b"\xff\xda")
    assert sos > 0
    seg_len = (data[sos + 2] << 8) | data[sos + 3]
    p = sos + 2 + seg_len + 40
    for i in range(12):
        b = data[p + i] ^ 0x55
        # avoid creating/destroying marker framing bytes
        if b in (0xFF, 0x00) or data[p + i] in (0xFF, 0x00):
            continue
        data[p + i] = b
    data = bytes(data)
    dec = OnchipProgressiveDecoder(**_KW)
    try:
        host.decode(data)
    except Exception:
        # host rejects it too: the on-chip path must not accept it
        out, ok = dec.decode([data, data])
        assert not bool(ok)
        return
    out, ok = dec.decode([data, data])
    if bool(ok):
        # both decoders accepted the damaged stream: results must agree
        want = _want(data)
        assert np.array_equal(np.asarray(out)[0], want)
    else:
        got = dec.decode_verified([data, data])
        want = _want(data)
        assert np.array_equal(got[0], want)
