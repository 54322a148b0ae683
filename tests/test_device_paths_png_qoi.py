"""PNG and QOI device paths of chip_smoke.py, bit-exact against the host
codecs at small sizes (see test_device_paths.py)."""

import pytest

import chip_smoke as smoke
from tools import corpus


def _passed(result):
    ok, line = result
    assert ok, line


@pytest.mark.parametrize("front", ["host", "defilter", "inflate"])
@pytest.mark.parametrize("name", ["ct2_d8.png", "ct6_d16.png",
                                  "ct0_d16_adam7.png", "ct3_d4_trns.png"])
def test_png_fronts(front, name):
    datas = [corpus.png_matrix()[name]] * 2
    _passed(smoke.phase_decode(f"png-{front}", datas, distinct=1, steady=1))


def test_png_distinct_images():
    datas = [corpus.png_bytes(corpus.photo(12, 20, s), color_type=2, depth=8)
             for s in (1, 2)] * 2
    _passed(smoke.phase_decode("png-host", datas, distinct=2, steady=1))


@pytest.mark.parametrize("content", ["noise", "screen"])
def test_qoi_hostindex(content):
    gen = corpus.noise if content == "noise" else corpus.screen
    datas = [corpus.qoi_bytes(gen(24, 32, s)) for s in (1, 2)] * 2
    _passed(smoke.phase_decode("qoi", datas, distinct=2, steady=1))


@pytest.mark.parametrize("content", ["noise", "screen"])
def test_qoi_encode_device(content):
    gen = corpus.noise if content == "noise" else corpus.screen
    _passed(smoke.phase_qoi_encode([gen(20, 28, 3)], steady=1))


def test_qoi_speculative():
    datas = [corpus.qoi_bytes(corpus.screen(16, 16, s)) for s in (1, 2)] * 2
    _passed(smoke.phase_decode("qoi-speculative", datas, distinct=2, steady=1))
