"""Device-resident progressive JPEG (sparse per-scan deltas) tests.

Every progressive corpus file must decode through DeviceProgressiveDecoder
bit-exactly versus the host-front-end batch decoder — same coefficient
algebra, so the device store after the last scan must equal the host's
(reference semantics decoder.zig:1268-1283, :1459-1549, :1636-1661).
"""

import os

import numpy as np
import pytest

from zpix.errors import UnsupportedError
from zpix.parallel.batch import BatchJpegDecoder
from zpix.parallel.progressive import DeviceProgressiveDecoder

PROGRESSIVE = [
    "video-001.progressive.jpeg",
    "video-001.q50.420.progressive.jpeg",
    "video-001.q50.444.progressive.jpeg",
    "video-001.q50.410.progressive.jpeg",
    "video-001.separate.dc.progression.progressive.jpeg",
    "video-005.gray.q50.progressive.jpeg",
]


@pytest.mark.parametrize("name", PROGRESSIVE)
def test_progressive_device_parity(testdata, name):
    path = os.path.join(testdata, name)
    if not os.path.exists(path):
        pytest.skip(f"{name} not in corpus")
    with open(path, "rb") as f:
        data = f.read()
    out = np.asarray(DeviceProgressiveDecoder().decode([data, data]))
    ref = np.asarray(BatchJpegDecoder().decode([data]))
    assert np.array_equal(out[0], ref[0]) and np.array_equal(out[1], ref[0])


def test_progressive_device_rejects_baseline(testdata):
    with open(os.path.join(testdata, "video-001.jpeg"), "rb") as f:
        data = f.read()
    with pytest.raises(UnsupportedError):
        DeviceProgressiveDecoder().decode([data])


def test_progressive_device_mixed_content(testdata):
    """Different progressive files of the same geometry decode in one
    batch even when their scan scripts differ in length."""
    names = ["video-001.progressive.jpeg", "video-001.q50.444.progressive.jpeg"]
    datas = [open(os.path.join(testdata, n), "rb").read() for n in names]
    out = np.asarray(DeviceProgressiveDecoder().decode(datas))
    for i, d in enumerate(datas):
        ref = np.asarray(BatchJpegDecoder().decode([d]))
        assert np.array_equal(out[i], ref[0]), names[i]
