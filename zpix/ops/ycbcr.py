"""Device-side chroma upsample + exact YCbCr->RGB (jax.numpy).

The same integer math as zpix/color/convert.py (reference:
/root/reference/src/image/util.zig:40-86) expressed in jnp so it fuses into
the batched decode graph.  Chroma upsampling is nearest/replication — the
reference's cOffset index math (/root/reference/src/image/image.zig:594-605)
— expressed as jnp.repeat so XLA lowers it to a broadcast, not a gather.
"""

from __future__ import annotations


def _clamp_shift_jnp(v, shift: int, mask: int):
    import jax.numpy as jnp

    v = v.astype(jnp.int32)
    in_range = (v.astype(jnp.uint32) & jnp.uint32(0xFF000000)) == 0
    clamped = (~(v >> jnp.int32(31))) & jnp.int32(mask)
    return jnp.where(in_range, v >> jnp.int32(shift), clamped)


def ycbcr_to_rgb8_jnp(y, cb, cr):
    """uint8 planes (broadcastable) -> uint8 R, G, B. Bit-exact vs numpy."""
    import jax.numpy as jnp

    yy1 = y.astype(jnp.int32) * jnp.int32(0x10101)
    cb1 = cb.astype(jnp.int32) - jnp.int32(128)
    cr1 = cr.astype(jnp.int32) - jnp.int32(128)
    r = _clamp_shift_jnp(yy1 + jnp.int32(91881) * cr1, 16, 0xFF)
    g = _clamp_shift_jnp(
        yy1 - jnp.int32(22554) * cb1 - jnp.int32(46802) * cr1, 16, 0xFF
    )
    b = _clamp_shift_jnp(yy1 + jnp.int32(116130) * cb1, 16, 0xFF)
    return r.astype(jnp.uint8), g.astype(jnp.uint8), b.astype(jnp.uint8)


def upsample_chroma_jnp(plane, h_factor: int, v_factor: int, out_h: int, out_w: int):
    """Replicate a [..., ch, cw] chroma plane to [..., out_h, out_w].

    Equivalent to indexing with (y // v_factor, x // h_factor) for planes
    whose padded size covers the output (always true for the 8x-block-padded
    decode planes).
    """
    import jax.numpy as jnp

    if v_factor > 1:
        plane = jnp.repeat(plane, v_factor, axis=-2)
    if h_factor > 1:
        plane = jnp.repeat(plane, h_factor, axis=-1)
    return plane[..., :out_h, :out_w]
