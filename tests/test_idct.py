"""IDCT exactness: vectorized vs serial reference semantics, and the JAX
implementation vs the numpy host oracle.

The serial model below is a direct transcription of the reference
algorithm's arithmetic (/root/reference/src/jpeg/idct.zig:77-201) used as a
differential oracle.
"""

import numpy as np
import pytest

from zpix.ops.idct import idct_batch, idct_batch_jax

W1, W2, W3, W5, W6, W7 = 2841, 2676, 2408, 1609, 1108, 565
W1PW7, W1MW7 = W1 + W7, W1 - W7
W2PW6, W2MW6 = W2 + W6, W2 - W6
W3PW5, W3MW5 = W3 + W5, W3 - W5
R2 = 181


def _i32(x):
    return ((x + 2**31) % 2**32) - 2**31


def _serial(src):
    s = [int(v) for v in src]
    for y in range(8):
        o = y * 8
        if all(s[o + i] == 0 for i in range(1, 8)):
            dc = _i32(s[o] << 3)
            s[o : o + 8] = [dc] * 8
            continue
        x0 = _i32((s[o] << 11) + 128)
        x1 = _i32(s[o + 4] << 11)
        x2, x3, x4, x5, x6, x7 = s[o + 6], s[o + 2], s[o + 1], s[o + 7], s[o + 5], s[o + 3]
        x8 = _i32(W7 * (x4 + x5))
        x4, x5 = _i32(x8 + W1MW7 * x4), _i32(x8 - W1PW7 * x5)
        x8 = _i32(W3 * (x6 + x7))
        x6, x7 = _i32(x8 - W3MW5 * x6), _i32(x8 - W3PW5 * x7)
        x8, x0 = _i32(x0 + x1), _i32(x0 - x1)
        x1 = _i32(W6 * (x3 + x2))
        x2, x3 = _i32(x1 - W2PW6 * x2), _i32(x1 + W2MW6 * x3)
        x1, x4 = _i32(x4 + x6), _i32(x4 - x6)
        x6, x5 = _i32(x5 + x7), _i32(x5 - x7)
        x7, x8 = _i32(x8 + x3), _i32(x8 - x3)
        x3, x0 = _i32(x0 + x2), _i32(x0 - x2)
        x2 = _i32(R2 * (x4 + x5) + 128) >> 8
        x4 = _i32(R2 * (x4 - x5) + 128) >> 8
        s[o : o + 8] = [
            _i32(x7 + x1) >> 8, _i32(x3 + x2) >> 8, _i32(x0 + x4) >> 8, _i32(x8 + x6) >> 8,
            _i32(x8 - x6) >> 8, _i32(x0 - x4) >> 8, _i32(x3 - x2) >> 8, _i32(x7 - x1) >> 8,
        ]
    for x in range(8):
        y0 = _i32((s[x] << 8) + 8192)
        y1 = _i32(s[32 + x] << 8)
        y2, y3, y4, y5, y6, y7 = s[48 + x], s[16 + x], s[8 + x], s[56 + x], s[40 + x], s[24 + x]
        y8 = _i32(W7 * (y4 + y5) + 4)
        y4, y5 = _i32(y8 + W1MW7 * y4) >> 3, _i32(y8 - W1PW7 * y5) >> 3
        y8 = _i32(W3 * (y6 + y7) + 4)
        y6, y7 = _i32(y8 - W3MW5 * y6) >> 3, _i32(y8 - W3PW5 * y7) >> 3
        y8, y0 = _i32(y0 + y1), _i32(y0 - y1)
        y1 = _i32(W6 * (y3 + y2) + 4)
        y2, y3 = _i32(y1 - W2PW6 * y2) >> 3, _i32(y1 + W2MW6 * y3) >> 3
        y1, y4 = _i32(y4 + y6), _i32(y4 - y6)
        y6, y5 = _i32(y5 + y7), _i32(y5 - y7)
        y7, y8 = _i32(y8 + y3), _i32(y8 - y3)
        y3, y0 = _i32(y0 + y2), _i32(y0 - y2)
        y2 = _i32(R2 * (y4 + y5) + 128) >> 8
        y4 = _i32(R2 * (y4 - y5) + 128) >> 8
        for i, v in enumerate(
            [
                _i32(y7 + y1) >> 14, _i32(y3 + y2) >> 14, _i32(y0 + y4) >> 14, _i32(y8 + y6) >> 14,
                _i32(y8 - y6) >> 14, _i32(y0 - y4) >> 14, _i32(y3 - y2) >> 14, _i32(y7 - y1) >> 14,
            ]
        ):
            s[8 * i + x] = v
    return s


def _random_blocks(n, seed=0):
    rng = np.random.default_rng(seed)
    blocks = rng.integers(-2048, 2048, (n, 64)).astype(np.int32)
    blocks[::5, 1:] = 0  # all-AC-zero rows exercise the DC shortcut
    mask = rng.random((n, 64)) < 0.6
    blocks = np.where(mask, blocks, 0)
    return blocks


def test_vectorized_matches_serial():
    blocks = _random_blocks(64)
    got = idct_batch(blocks.reshape(-1, 8, 8)).reshape(-1, 64)
    for i in range(len(blocks)):
        assert list(got[i]) == _serial(blocks[i]), f"block {i}"


def test_jax_matches_numpy():
    blocks = _random_blocks(256, seed=1).reshape(-1, 8, 8)
    want = idct_batch(blocks)
    got = np.asarray(idct_batch_jax(blocks))
    assert np.array_equal(got, want)


def test_dc_only_shortcut_equivalence():
    """floor((dc*2048+128)/256) == dc*8 for either sign — the reference's
    all-AC-zero row shortcut is exact, so the branch-free path must agree."""
    dcs = np.arange(-1024, 1025, dtype=np.int32)
    blocks = np.zeros((len(dcs), 64), np.int32)
    blocks[:, 0] = dcs
    got = idct_batch(blocks.reshape(-1, 8, 8)).reshape(-1, 64)
    for i, dc in enumerate(dcs):
        assert list(got[i]) == _serial(blocks[i]), f"dc={dc}"
