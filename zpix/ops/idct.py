"""Exact fixed-point 8x8 inverse DCT (Wang 1984), batched.

Reproduces the reference IDCT (/root/reference/src/jpeg/idct.zig:77-201)
bit-for-bit: scaled constants w1..w7 = 2048*sqrt(2)*cos(k*pi/16), the
4-stage butterfly, and every intermediate shift/round.  This is the JPEG
sample-exactness contract (BASELINE.md).

The reference short-circuits rows whose AC coefficients are all zero to
``dc << 3`` (idct.zig:84-97).  That branch is *numerically identical* to the
full butterfly: with all-AC-zero input the row pass reduces to
``((dc << 11) + 128) >> 8`` and, because ``dc << 11`` is a multiple of 256,
``floor((dc*2048 + 128)/256) == dc*8`` for either sign.  We therefore run
the branch-free butterfly on every lane — the vectorized form.

Two implementations share one algorithm expressed over a generic namespace:
  * idct_batch      — numpy int32, host oracle
  * idct_batch_jax  — jnp int32, fuses into the XLA decode graph
"""

from __future__ import annotations

import numpy as np

W1 = 2841  # 2048*sqrt(2)*cos(1*pi/16)
W2 = 2676  # 2048*sqrt(2)*cos(2*pi/16)
W3 = 2408  # 2048*sqrt(2)*cos(3*pi/16)
W5 = 1609  # 2048*sqrt(2)*cos(5*pi/16)
W6 = 1108  # 2048*sqrt(2)*cos(6*pi/16)
W7 = 565   # 2048*sqrt(2)*cos(7*pi/16)
W1PW7 = W1 + W7
W1MW7 = W1 - W7
W2PW6 = W2 + W6
W2MW6 = W2 - W6
W3PW5 = W3 + W5
W3MW5 = W3 - W5
R2 = 181  # 256/sqrt(2)


def _row_pass(s, xp):
    """Horizontal 1-D IDCT on s[..., 8, 8] int32 (idct.zig:79-145).

    Returns the transformed rows.  ``xp`` is numpy or jax.numpy.
    """
    c = lambda v: xp.int32(v)  # noqa: E731

    x0 = (s[..., 0] << c(11)) + c(128)
    x1 = s[..., 4] << c(11)
    x2 = s[..., 6]
    x3 = s[..., 2]
    x4 = s[..., 1]
    x5 = s[..., 7]
    x6 = s[..., 5]
    x7 = s[..., 3]

    # Stage 1.
    x8 = c(W7) * (x4 + x5)
    x4 = x8 + c(W1MW7) * x4
    x5 = x8 - c(W1PW7) * x5
    x8 = c(W3) * (x6 + x7)
    x6 = x8 - c(W3MW5) * x6
    x7 = x8 - c(W3PW5) * x7

    # Stage 2.
    x8 = x0 + x1
    x0 = x0 - x1
    x1 = c(W6) * (x3 + x2)
    x2 = x1 - c(W2PW6) * x2
    x3 = x1 + c(W2MW6) * x3
    x1 = x4 + x6
    x4 = x4 - x6
    x6 = x5 + x7
    x5 = x5 - x7

    # Stage 3.
    x7 = x8 + x3
    x8 = x8 - x3
    x3 = x0 + x2
    x0 = x0 - x2
    x2 = (c(R2) * (x4 + x5) + c(128)) >> c(8)
    x4 = (c(R2) * (x4 - x5) + c(128)) >> c(8)

    # Stage 4.
    return xp.stack(
        [
            (x7 + x1) >> c(8),
            (x3 + x2) >> c(8),
            (x0 + x4) >> c(8),
            (x8 + x6) >> c(8),
            (x8 - x6) >> c(8),
            (x0 - x4) >> c(8),
            (x3 - x2) >> c(8),
            (x7 - x1) >> c(8),
        ],
        axis=-1,
    )


def _col_pass(s, xp):
    """Vertical 1-D IDCT on s[..., 8, 8] int32 (idct.zig:148-200)."""
    c = lambda v: xp.int32(v)  # noqa: E731

    y0 = (s[..., 0, :] << c(8)) + c(8192)
    y1 = s[..., 4, :] << c(8)
    y2 = s[..., 6, :]
    y3 = s[..., 2, :]
    y4 = s[..., 1, :]
    y5 = s[..., 7, :]
    y6 = s[..., 5, :]
    y7 = s[..., 3, :]

    # Stage 1.
    y8 = c(W7) * (y4 + y5) + c(4)
    y4 = (y8 + c(W1MW7) * y4) >> c(3)
    y5 = (y8 - c(W1PW7) * y5) >> c(3)
    y8 = c(W3) * (y6 + y7) + c(4)
    y6 = (y8 - c(W3MW5) * y6) >> c(3)
    y7 = (y8 - c(W3PW5) * y7) >> c(3)

    # Stage 2.
    y8 = y0 + y1
    y0 = y0 - y1
    y1 = c(W6) * (y3 + y2) + c(4)
    y2 = (y1 - c(W2PW6) * y2) >> c(3)
    y3 = (y1 + c(W2MW6) * y3) >> c(3)
    y1 = y4 + y6
    y4 = y4 - y6
    y6 = y5 + y7
    y5 = y5 - y7

    # Stage 3.
    y7 = y8 + y3
    y8 = y8 - y3
    y3 = y0 + y2
    y0 = y0 - y2
    y2 = (c(R2) * (y4 + y5) + c(128)) >> c(8)
    y4 = (c(R2) * (y4 - y5) + c(128)) >> c(8)

    # Stage 4.
    return xp.stack(
        [
            (y7 + y1) >> c(14),
            (y3 + y2) >> c(14),
            (y0 + y4) >> c(14),
            (y8 + y6) >> c(14),
            (y8 - y6) >> c(14),
            (y0 - y4) >> c(14),
            (y3 - y2) >> c(14),
            (y7 - y1) >> c(14),
        ],
        axis=-2,
    )


def idct_batch(blocks: np.ndarray) -> np.ndarray:
    """2-D IDCT over [..., 8, 8] int32 blocks (numpy host path)."""
    s = blocks.astype(np.int32, copy=False)
    s = _row_pass(s, np)
    return _col_pass(s, np)


_IDCT_JIT = None


def idct_batch_jax(blocks):
    """Same transform under jax.numpy, jitted (shape-polymorphic cache)."""
    global _IDCT_JIT
    if _IDCT_JIT is None:
        import jax

        def _f(b):
            import jax.numpy as jnp

            s = b.astype(jnp.int32)
            return _col_pass(_row_pass(s, jnp), jnp)

        _IDCT_JIT = jax.jit(_f)
    return _IDCT_JIT(blocks)


def level_shift_np(blocks: np.ndarray) -> np.ndarray:
    """+128 level shift with the reference's saturation.

    Mirrors reconstructBlock step 4
    (/root/reference/src/jpeg/decoder.zig:1611-1633): coefficients < -128
    clamp to 0, > 127 clamp to 255, else +128.
    """
    return np.clip(blocks + 128, 0, 255).astype(np.uint8)


def _butterfly_row_list(s, xp):
    """Row-pass butterfly over 8 per-column arrays (each any shape)."""
    c = lambda v: xp.int32(v)  # noqa: E731
    x0 = (s[0] << c(11)) + c(128)
    x1 = s[4] << c(11)
    x2, x3, x4, x5, x6, x7 = s[6], s[2], s[1], s[7], s[5], s[3]
    x8 = c(W7) * (x4 + x5)
    x4, x5 = x8 + c(W1MW7) * x4, x8 - c(W1PW7) * x5
    x8 = c(W3) * (x6 + x7)
    x6, x7 = x8 - c(W3MW5) * x6, x8 - c(W3PW5) * x7
    x8, x0 = x0 + x1, x0 - x1
    x1 = c(W6) * (x3 + x2)
    x2, x3 = x1 - c(W2PW6) * x2, x1 + c(W2MW6) * x3
    x1, x4 = x4 + x6, x4 - x6
    x6, x5 = x5 + x7, x5 - x7
    x7, x8 = x8 + x3, x8 - x3
    x3, x0 = x0 + x2, x0 - x2
    x2 = (c(R2) * (x4 + x5) + c(128)) >> c(8)
    x4 = (c(R2) * (x4 - x5) + c(128)) >> c(8)
    return [
        (x7 + x1) >> c(8), (x3 + x2) >> c(8), (x0 + x4) >> c(8), (x8 + x6) >> c(8),
        (x8 - x6) >> c(8), (x0 - x4) >> c(8), (x3 - x2) >> c(8), (x7 - x1) >> c(8),
    ]


def _butterfly_col_list(s, xp):
    """Column-pass butterfly over 8 per-row arrays (each any shape)."""
    c = lambda v: xp.int32(v)  # noqa: E731
    y0 = (s[0] << c(8)) + c(8192)
    y1 = s[4] << c(8)
    y2, y3, y4, y5, y6, y7 = s[6], s[2], s[1], s[7], s[5], s[3]
    y8 = c(W7) * (y4 + y5) + c(4)
    y4, y5 = (y8 + c(W1MW7) * y4) >> c(3), (y8 - c(W1PW7) * y5) >> c(3)
    y8 = c(W3) * (y6 + y7) + c(4)
    y6, y7 = (y8 - c(W3MW5) * y6) >> c(3), (y8 - c(W3PW5) * y7) >> c(3)
    y8, y0 = y0 + y1, y0 - y1
    y1 = c(W6) * (y3 + y2) + c(4)
    y2, y3 = (y1 - c(W2PW6) * y2) >> c(3), (y1 + c(W2MW6) * y3) >> c(3)
    y1, y4 = y4 + y6, y4 - y6
    y6, y5 = y5 + y7, y5 - y7
    y7, y8 = y8 + y3, y8 - y3
    y3, y0 = y0 + y2, y0 - y2
    y2 = (c(R2) * (y4 + y5) + c(128)) >> c(8)
    y4 = (c(R2) * (y4 - y5) + c(128)) >> c(8)
    return [
        (y7 + y1) >> c(14), (y3 + y2) >> c(14), (y0 + y4) >> c(14), (y8 + y6) >> c(14),
        (y8 - y6) >> c(14), (y0 - y4) >> c(14), (y3 - y2) >> c(14), (y7 - y1) >> c(14),
    ]
