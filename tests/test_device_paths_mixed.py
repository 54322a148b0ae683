"""Progressive JPEG and the public decode_mixed API, as chip_smoke.py runs
them, bit-exact against the host codecs at small sizes."""

import pytest

import chip_smoke as smoke
from tools import corpus
from zpix.errors import FormatError
from zpix.parallel import bucketing


def _passed(result):
    ok, line = result
    assert ok, line


def test_jpeg_progressive():
    datas = [corpus.read("prog444.jpg")] * 2
    _passed(smoke.phase_decode("progressive", datas, distinct=1, steady=1))


def test_decode_mixed_every_format():
    _passed(smoke.phase_decode_mixed(smoke.mixed_inputs(large=False),
                                     steady=1))


def _failing_bmp_decoder(exc):
    class Dec:
        def __init__(self, mesh=None):
            pass

        def decode(self, datas):
            raise exc

    return Dec


def test_decode_mixed_reraises_non_format_errors(monkeypatch):
    from zpix.parallel import bmp_batch

    monkeypatch.setattr(bmp_batch, "BatchBmpDecoder",
                        _failing_bmp_decoder(RuntimeError("device failed")))
    with pytest.raises(RuntimeError, match="device failed"):
        bucketing.decode_mixed([corpus.bmp_set()["rgb24.bmp"]])


def test_decode_mixed_routes_format_errors_to_host(monkeypatch):
    from zpix.parallel import bmp_batch

    monkeypatch.setattr(bmp_batch, "BatchBmpDecoder",
                        _failing_bmp_decoder(FormatError("bad stream")))
    data = corpus.bmp_set()["rgb24.bmp"]
    outs, stats = bucketing.decode_mixed([data], return_stats=True)
    assert stats == {"host-error": 1}
    assert (outs[0] == smoke.host_rgba(data)).all()


def test_decode_mixed_reuses_decoders_across_calls():
    """A repeated bucket reuses its decoder (and compiled programs)."""
    bufs = [corpus.qoi_bytes(corpus.screen(12, 16, 1))]
    bucketing.decode_mixed(bufs)
    before = dict(bucketing._DECODERS)
    outs = bucketing.decode_mixed(bufs)
    assert bucketing._DECODERS == before
    assert (outs[0] == smoke.host_rgba(bufs[0])).all()
