"""Every device path chip_smoke.py runs, bit-exact against the host codecs
on the committed corpus and the seeded writers, at small sizes.

The phases are chip_smoke's own, so a CPU run rehearses the smoke script's
decoders, inputs and checks; chip_smoke.py runs the same phases at 16 x
1024² on the GPU.
"""

import numpy as np
import pytest

import chip_smoke as smoke
from tools import corpus


def _passed(result):
    ok, line = result
    assert ok, line


def test_jpeg_restart_pipeline():
    datas = [corpus.read("420_dri.jpg")] * 2
    _passed(smoke.phase_jpeg_restart(datas, distinct=1, steady=1))


@pytest.mark.parametrize("name", ["gray.jpg", "444.jpg", "422.jpg"])
def test_jpeg_restart_free(name):
    datas = [corpus.read(name)] * 2
    _passed(smoke.phase_decode("restart-free", datas, distinct=1, steady=1))


@pytest.mark.parametrize("name", ["gray.jpg", "444.jpg", "422.jpg",
                                  "420_dri.jpg"])
def test_jpeg_host_entropy(name):
    datas = [corpus.read(name)] * 2
    _passed(smoke.phase_decode("host-entropy", datas, distinct=1, steady=1))


@pytest.mark.parametrize("name", ["rgb24.bmp", "rgb24_topdown.bmp",
                                  "pal1.bmp", "pal4.bmp", "pal8.bmp"])
def test_bmp(name):
    datas = [corpus.bmp_set()[name]] * 2
    _passed(smoke.phase_decode("bmp", datas, distinct=1, steady=1))


def test_bmp_distinct_images():
    datas = [corpus.bmp_bytes(corpus.photo(16, 24, s)) for s in (1, 2)] * 2
    _passed(smoke.phase_decode("bmp", datas, distinct=2, steady=1))


def test_check_batch_catches_a_bad_copy():
    datas = [corpus.bmp_bytes(corpus.photo(8, 8, s)) for s in (1, 2)] * 2
    out = np.stack([smoke.host_rgba(d) for d in datas])
    assert "bit-exact" in smoke.check_batch(out, datas, 2)
    out[3, 0, 0, 0] ^= 1
    with pytest.raises(AssertionError, match="copy 3"):
        smoke.check_batch(out, datas, 2)
