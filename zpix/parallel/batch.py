"""Batched JPEG decode: host entropy front-end -> one jitted device graph.

Pipeline (north-star config, BASELINE.md):
  1. front-end: per-image entropy decode to coefficient tensors
     [bv, bh, 64] int32 per component (host scan or native runtime;
     embarrassingly parallel across the batch)
  2. device graph (jit, sharded over the mesh): dequant -> exact Wang IDCT
     -> +128 level shift -> plane assembly -> chroma upsample ->
     exact integer YCbCr->RGB  (all fused by XLA into a few kernels)

Every image in a batch must share (height, width, ratio) — the padded
bucketing strategy SURVEY.md sec.7 calls for; mixed sizes go in separate
buckets/graphs.
"""

from __future__ import annotations

import numpy as np

from ..codecs.jpeg.decoder import Decoder
from ..codecs.jpeg.tables import UNZIG
from ..image.model import chroma_dims
from ..ops.idct import _col_pass, _row_pass
from ..ops.ycbcr import upsample_chroma_jnp, ycbcr_to_rgb8_jnp


class FrontEndResult:
    """Per-image entropy-decode output."""

    __slots__ = (
        "width", "height", "ratio", "ncomp", "coeffs", "quants", "hv", "color"
    )

    def __init__(self, width, height, ratio, ncomp, coeffs, quants, hv,
                 color="ycbcr"):
        self.width = width
        self.height = height
        self.ratio = ratio
        self.ncomp = ncomp
        self.coeffs = coeffs  # list of [bv, bh, 64] int32 (natural order)
        self.quants = quants  # list of [64] int32 (natural order)
        self.hv = hv  # list of (h, v)
        # "gray" | "ycbcr" | "rgb" | "ycck" | "cmyk" | "cmyk?" (4-comp with
        # no Adobe marker: the reference errors, decoder.zig:795-799)
        self.color = color


def parse_coefficients(data: bytes) -> FrontEndResult:
    """Entropy-decode a JPEG to coefficient tensors without reconstructing."""
    from ..codecs.jpeg.decoder import ADOBE_UNKNOWN

    d = Decoder(data)
    d.collect_only = True
    d.decode_inner(False)
    ncomp = d.num_components
    ratio = d._subsample_ratio() if ncomp >= 3 else "gray"
    if ncomp == 1:
        color = "gray"
    elif ncomp == 3:
        color = "rgb" if d.is_rgb() else "ycbcr"
    elif not d.adobe_transform_valid:
        color = "cmyk?"
    else:
        color = "cmyk" if d.adobe_transform == ADOBE_UNKNOWN else "ycck"
    coeffs, quants, hv = [], [], []
    for i in range(ncomp):
        coeffs.append(d.coeff[i] if d.coeff[i] is not None else None)
        qzig = d.quant[d.component[i].tq]
        qnat = np.empty(64, np.int32)
        qnat[UNZIG] = qzig
        quants.append(qnat)
        hv.append((d.component[i].h, d.component[i].v))
    return FrontEndResult(
        d.width, d.height, ratio, ncomp, coeffs, quants, hv, color
    )


def _blocks_to_plane(jnp, blocks):
    """[B, bv, bh, 8, 8] -> [B, 8*bv, 8*bh]."""
    b, bv, bh = blocks.shape[0], blocks.shape[1], blocks.shape[2]
    return jnp.transpose(blocks, (0, 1, 3, 2, 4)).reshape(b, bv * 8, bh * 8)


def _component_plane(jnp, coeff, quant):
    """Dequant + IDCT + level shift one component: [B,bv,bh,64] -> plane.

    coeff may arrive as int16 (the host->device transfer format; JPEG
    coefficients fit: |value| < 2^15) and is widened on device.
    """
    deq = coeff.astype(jnp.int32) * quant[:, None, None, :]
    blocks = deq.reshape(deq.shape[:-1] + (8, 8))
    out = _col_pass(_row_pass(blocks, jnp), jnp)
    pix = jnp.clip(out + jnp.int32(128), 0, 255).astype(jnp.uint8)
    return _blocks_to_plane(jnp, pix)


_RATIO_FACTORS = {
    "444": (1, 1),
    "422": (2, 1),
    "420": (2, 2),
    "440": (1, 2),
    "411": (4, 1),
    "410": (4, 2),
}


def _ycbcr_graph(cy, ccb, ccr, qy, qcb, qcr, *, height, width, ratio):
    """Device graph: coefficients -> interleaved RGB8 [B, H, W, 3].

    cy/ccb/ccr: [B, bv, bh, 64] int32; qy/qcb/qcr: [B, 64] int32.
    """
    import jax.numpy as jnp

    y = _component_plane(jnp, cy, qy)[:, :height, :width]
    cb_p = _component_plane(jnp, ccb, qcb)
    cr_p = _component_plane(jnp, ccr, qcr)
    hf, vf = _RATIO_FACTORS[ratio]
    cb = upsample_chroma_jnp(cb_p, hf, vf, height, width)
    cr = upsample_chroma_jnp(cr_p, hf, vf, height, width)
    r, g, b = ycbcr_to_rgb8_jnp(y, cb, cr)
    return jnp.stack([r, g, b], axis=-1)


def _gray_graph(cy, qy, *, height, width):
    import jax.numpy as jnp

    return _component_plane(jnp, cy, qy)[:, :height, :width]


def _rgb_graph(cr_, cg, cb_, qr, qg, qb, *, height, width, ratio):
    """RGB JPEG: interleave the three planes directly (convertToRGB,
    decoder.zig:751-783), upsampling subsampled G/B with the same
    replication index math (c_scale)."""
    import jax.numpy as jnp

    r = _component_plane(jnp, cr_, qr)[:, :height, :width]
    hf, vf = _RATIO_FACTORS[ratio]
    g = upsample_chroma_jnp(_component_plane(jnp, cg, qg), hf, vf, height, width)
    b = upsample_chroma_jnp(_component_plane(jnp, cb_, qb), hf, vf, height, width)
    return jnp.stack([r, g, b], axis=-1)


def _ycck_graph(cy, ccb, ccr, ck, qy, qcb, qcr, qk, *, height, width, ratio):
    """YCCK (Adobe transform != unknown): YCbCr -> RGB cancels the Adobe
    inversion, K patches in inverted (applyBlack, decoder.zig:811-846).
    Output channels mirror the host CMYKImage: (r, g, b, 255-k)."""
    import jax.numpy as jnp

    y = _component_plane(jnp, cy, qy)[:, :height, :width]
    hf, vf = _RATIO_FACTORS[ratio]
    cb = upsample_chroma_jnp(_component_plane(jnp, ccb, qcb), hf, vf, height, width)
    cr = upsample_chroma_jnp(_component_plane(jnp, ccr, qcr), hf, vf, height, width)
    r, g, b = ycbcr_to_rgb8_jnp(y, cb, cr)
    k = _component_plane(jnp, ck, qk)[:, :height, :width]
    return jnp.stack([r, g, b, jnp.uint8(255) - k], axis=-1)


def _cmyk_graph(c0, c1, c2, c3, q0, q1, q2, q3, *, height, width, sub):
    """Raw CMYK (Adobe transform == unknown): interleave the four planes
    with 255-v inversion; `sub[t]` marks 2x2-subsampled components
    (applyBlack raw arm, decoder.zig:852-901 — the SOF matrix only
    admits all-1x1 or {2x2,1x1,1x1,2x2}, decoder.zig:595-611)."""
    import jax.numpy as jnp

    chans = []
    for coeff, q, s in zip((c0, c1, c2, c3), (q0, q1, q2, q3), sub):
        p = _component_plane(jnp, coeff, q)
        if s:
            p = upsample_chroma_jnp(p, 2, 2, height, width)
        else:
            p = p[:, :height, :width]
        chans.append(jnp.uint8(255) - p)
    return jnp.stack(chans, axis=-1)


_JITTED: dict = {}


def _jitted(name, fn, static):
    if name not in _JITTED:
        import jax

        _JITTED[name] = jax.jit(fn, static_argnames=static)
    return _JITTED[name]


def decode_batch_ycbcr_to_rgb(cy, ccb, ccr, qy, qcb, qcr, *, height, width, ratio):
    return _jitted("ycbcr", _ycbcr_graph, ("height", "width", "ratio"))(
        cy, ccb, ccr, qy, qcb, qcr, height=height, width=width, ratio=ratio
    )


def decode_batch_gray(cy, qy, *, height, width):
    return _jitted("gray", _gray_graph, ("height", "width"))(
        cy, qy, height=height, width=width
    )


class PackedFrontEnd:
    """Sparse-packed per-image front-end output (native full parser).

    Blocks are in *stream* (MCU-interleaved) order; ``perms[c]`` maps grid
    index -> stream index (None when stream order == grid order), applied
    on-device after unpacking.
    """

    __slots__ = (
        "width", "height", "ratio", "ncomp", "bitmaps", "vals", "quants", "hv", "perms"
    )

    def __init__(self, width, height, ratio, ncomp, bitmaps, vals, quants, hv, perms):
        self.width = width
        self.height = height
        self.ratio = ratio
        self.ncomp = ncomp
        self.bitmaps = bitmaps  # list of [nb, 8] uint8
        self.vals = vals  # list of int16[nnz]
        self.quants = quants  # list of [64] int32 natural order
        self.hv = hv
        self.perms = perms


_PERM_CACHE: dict = {}


def stream_perm(mxx: int, myy: int, hi: int, vi: int):
    """grid->stream index map for one component of an interleaved scan.

    Stream order is (my, mx, j) with by = vi*my + j//hi, bx = hi*mx + j%hi
    (decoder.zig:1327-1329); returns None when that equals row-major grid
    order (hi == vi == 1, or a single-MCU column/row special case).
    """
    if hi == 1 and vi == 1:
        return None
    key = (mxx, myy, hi, vi)
    if key not in _PERM_CACHE:
        j = np.arange(hi * vi)
        my, mx, jj = np.meshgrid(
            np.arange(myy), np.arange(mxx), j, indexing="ij"
        )
        by = vi * my + jj // hi
        bx = hi * mx + jj % hi
        grid_of_stream = (by * (mxx * hi) + bx).reshape(-1)
        inv = np.empty_like(grid_of_stream)
        inv[grid_of_stream] = np.arange(len(grid_of_stream))
        _PERM_CACHE[key] = inv.astype(np.int32)
    return _PERM_CACHE[key]


def _peek_sof(data: bytes):
    """Cheap scan for SOF0/1 dims + sampling factors (sizing only)."""
    pos = 2
    n = len(data)
    while pos + 4 <= n:
        if data[pos] != 0xFF:
            pos += 1
            continue
        marker = data[pos + 1]
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            pos += 2
            continue
        ln = (data[pos + 2] << 8) | data[pos + 3]
        if marker in (0xC0, 0xC1):
            seg = data[pos + 4 : pos + 2 + ln]
            if len(seg) < 6:
                return None
            h = (seg[1] << 8) | seg[2]
            w = (seg[3] << 8) | seg[4]
            nc = seg[5]
            hv = []
            for i in range(nc):
                b = seg[7 + 3 * i]
                hv.append((b >> 4, b & 0x0F))
            if nc == 1:
                hv = [(1, 1)]
            return w, h, nc, hv
        if marker == 0xDA:
            return None
        pos += 2 + ln
    return None


def parse_packed_native(data: bytes, n_threads: int = 1):
    """Full native front-end: bytes -> PackedFrontEnd, or None (fallback).

    n_threads > 1 enables intra-image restart-segment parallel decoding
    when the stream carries restart markers.
    """
    from .. import runtime

    lib = runtime.get_lib()
    if lib is None:
        return None
    sof = _peek_sof(data)
    if sof is None or sof[2] not in (1, 3):
        return None
    import ctypes

    w, h, nc, hv = sof
    h0, v0 = hv[0]
    mxx = (w + 8 * h0 - 1) // (8 * h0)
    myy = (h + 8 * v0 - 1) // (8 * v0)

    bitmaps, vals, caps = [], [], []
    bm_ptrs = (ctypes.POINTER(ctypes.c_uint8) * 4)()
    val_ptrs = (ctypes.POINTER(ctypes.c_int16) * 4)()
    cap_arr = (ctypes.c_int64 * 4)()
    for i in range(nc):
        hi, vi = hv[i]
        nb = mxx * hi * myy * vi
        bm = np.empty((nb, 8), np.uint8)
        vl = np.empty(nb * 64, np.int16)
        bitmaps.append(bm)
        vals.append(vl)
        bm_ptrs[i] = bm.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        val_ptrs[i] = vl.ctypes.data_as(ctypes.POINTER(ctypes.c_int16))
        cap_arr[i] = nb * 64
    quant_nat = np.zeros((3, 64), np.int32)
    nnz = (ctypes.c_int64 * 4)()

    rc = lib.zpix_parse_baseline(
        data,
        len(data),
        w,
        h,
        bm_ptrs,
        val_ptrs,
        cap_arr,
        quant_nat.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        nnz,
        n_threads,
    )
    if rc != 0:
        return None

    if nc == 1:
        ratio = "gray"
    else:
        h_ratio = hv[0][0] // hv[1][0]
        v_ratio = hv[0][1] // hv[1][1]
        ratio = {
            0x11: "444", 0x12: "440", 0x21: "422",
            0x22: "420", 0x41: "411", 0x42: "410",
        }.get((h_ratio << 4) | v_ratio)
        if ratio is None:
            return None
    return PackedFrontEnd(
        w, h, ratio, nc,
        bitmaps,
        [vals[i][: nnz[i]] for i in range(nc)],
        [quant_nat[i] for i in range(nc)],
        hv,
        [stream_perm(mxx, myy, hv[i][0], hv[i][1]) for i in range(nc)],
    )


class NativeBatchFrontEnd:
    """Whole-batch native front-end: one C call, internal thread pool.

    Parses N same-geometry baseline JPEGs into persistent sparse-packed
    buffers (reused across steps — zero allocation in steady state).

    With ``flat=True`` every output lives inside ONE contiguous uint8
    buffer (bitmaps then int16 values at fixed offsets), so the whole
    batch ships to the device in a single transfer (one round trip per
    batch instead of one per array).  Value capacity is fixed at ``val_cap_frac`` of dense
    (default 1/8 = 12.5% density); denser images raise and should use the
    non-flat path.
    """

    VAL_CAP_FRAC = 8  # cap = nb * 64 / VAL_CAP_FRAC values per image

    def __init__(self, sample: bytes, batch: int, n_threads: int | None = None, flat: bool = True):
        import ctypes
        import os as _os

        from .. import runtime

        self._runtime = runtime
        self._ctypes = ctypes
        self.lib = runtime.get_lib()
        if self.lib is None:
            raise RuntimeError("native runtime unavailable")
        sof = _peek_sof(sample)
        if sof is None or sof[2] not in (1, 3):
            raise ValueError("not a supported baseline JPEG")
        self.width, self.height, self.ncomp, self.hv = sof
        h0, v0 = self.hv[0]
        self.mxx = (self.width + 8 * h0 - 1) // (8 * h0)
        self.myy = (self.height + 8 * v0 - 1) // (8 * v0)
        self.batch = batch
        self.n_threads = n_threads or (_os.cpu_count() or 2)

        self.flat = flat
        self.nb = []
        self.val_caps = []
        sample_nnz = None
        if flat:
            # Size value capacity from the sample image's actual density
            # (2x headroom), floored at 1/8 dense; denser batch members
            # raise cleanly and should use the non-flat path.
            p = parse_packed_native(sample)
            if p is not None:
                sample_nnz = [len(v) for v in p.vals]
        for c in range(self.ncomp):
            hi, vi = self.hv[c]
            nb = self.mxx * hi * self.myy * vi
            self.nb.append(nb)
            if flat:
                cap = nb * 64 // self.VAL_CAP_FRAC
                if sample_nnz is not None:
                    cap = max(cap, 2 * sample_nnz[c])
                cap = min((cap + 511) // 512 * 512, nb * 64)
            else:
                cap = nb * 64
            self.val_caps.append(cap)

        self.bitmaps = []
        self.vals = []
        self.quants = []
        if flat:
            # One contiguous transfer buffer: [bitmaps per comp][vals per
            # comp], every section per-image contiguous, 64-byte aligned.
            self.layout = []  # (kind, comp, offset, nbytes)
            off = 0
            for c in range(self.ncomp):
                nbytes = batch * self.nb[c] * 8
                self.layout.append(("bm", c, off, nbytes))
                off += (nbytes + 63) // 64 * 64
            for c in range(self.ncomp):
                nbytes = batch * self.val_caps[c] * 2
                self.layout.append(("val", c, off, nbytes))
                off += (nbytes + 63) // 64 * 64
            self.buffer = np.zeros(off, np.uint8)
            for kind, c, o, nbytes in self.layout:
                if kind == "bm":
                    self.bitmaps.append(
                        self.buffer[o : o + nbytes].reshape(batch, self.nb[c], 8)
                    )
                else:
                    self.vals.append(
                        self.buffer[o : o + nbytes].view(np.int16).reshape(
                            batch, self.val_caps[c]
                        )
                    )
        else:
            for c in range(self.ncomp):
                self.bitmaps.append(np.empty((batch, self.nb[c], 8), np.uint8))
                self.vals.append(np.empty((batch, self.val_caps[c]), np.int16))
        for c in range(self.ncomp):
            self.quants.append(np.empty((batch, 64), np.int32))
        self.nnz = np.empty((batch, 3), np.int64)
        self.rcs = np.empty(batch, np.int32)
        # Y blocks arrive in MCU-interleaved stream order; device unpacking
        # applies this grid->stream gather (None = already row-major).
        self.perm_y = stream_perm(self.mxx, self.myy, self.hv[0][0], self.hv[0][1])
        self.perm_c = (
            stream_perm(self.mxx, self.myy, self.hv[1][0], self.hv[1][1])
            if self.ncomp >= 3
            else None
        )

        if self.ncomp == 1:
            self.ratio = "gray"
        else:
            hr = self.hv[0][0] // self.hv[1][0]
            vr = self.hv[0][1] // self.hv[1][1]
            self.ratio = {
                0x11: "444", 0x12: "440", 0x21: "422",
                0x22: "420", 0x41: "411", 0x42: "410",
            }[(hr << 4) | vr]

    def parse(self, datas: list[bytes]) -> None:
        """Parse the batch into the persistent buffers (one C call)."""
        ct = self._ctypes
        b = len(datas)
        if b != self.batch:
            raise ValueError("batch size mismatch")
        data_ptrs = (ct.c_char_p * b)(*datas)
        lens = (ct.c_int64 * b)(*[len(d) for d in datas])
        bm_ptrs = (ct.POINTER(ct.c_uint8) * 4)()
        val_ptrs = (ct.POINTER(ct.c_int16) * 4)()
        q_ptrs = (ct.POINTER(ct.c_int32) * 4)()
        caps = (ct.c_int64 * 4)()
        strides = (ct.c_int64 * 4)()
        for c in range(self.ncomp):
            bm_ptrs[c] = self.bitmaps[c].ctypes.data_as(ct.POINTER(ct.c_uint8))
            val_ptrs[c] = self.vals[c].ctypes.data_as(ct.POINTER(ct.c_int16))
            q_ptrs[c] = self.quants[c].ctypes.data_as(ct.POINTER(ct.c_int32))
            caps[c] = self.val_caps[c]
            strides[c] = self.nb[c] * 8
        rc = self.lib.zpix_parse_baseline_batch(
            data_ptrs, lens, b, self.width, self.height, self.ncomp,
            bm_ptrs, val_ptrs, caps, strides, q_ptrs,
            self.nnz.ctypes.data_as(ct.POINTER(ct.c_int64)),
            self.rcs.ctypes.data_as(ct.POINTER(ct.c_int32)),
            self.n_threads,
        )
        if rc != 0:
            raise RuntimeError(
                f"native batch front-end failed: rc={rc} "
                "(dense image exceeding the value cap? use the non-flat path)"
            )

    def __call__(self, datas: list[bytes]):
        """Parse + return (bitmaps, vals_sliced, quants) for per-array
        transfer.  vals_sliced is [B, max_nnz_rounded] per component."""
        self.parse(datas)
        vals_sliced = []
        for c in range(self.ncomp):
            cap = int(self.nnz[:, c].max())
            cap = max(512, (cap + 511) // 512 * 512)
            cap = min(cap, self.val_caps[c])
            v = self.vals[c][:, :cap].copy()
            # zero the padding tail per row (stale values are masked out by
            # the bitmap on device, but keep transfers deterministic)
            for i in range(len(datas)):
                v[i, int(self.nnz[i, c]):] = 0
            vals_sliced.append(v)
        return self.bitmaps, vals_sliced, self.quants


# ----------------------------------------------------------------------
# Sparse coefficient transfer: bitmap + nonzero values
# ----------------------------------------------------------------------
#
# Coefficient tensors are ~95% zero; to cut host->device bytes, blocks travel
# as a 64-bit nonzero bitmap + int16 values (~8x smaller) and are unpacked
# on-device inside the jit graph.


def pack_sparse(coeff: np.ndarray):
    """[bv, bh, 64] int32 -> (bitmap [nb,8] uint8, vals int16[nnz])."""
    from .. import runtime

    nb = coeff.shape[0] * coeff.shape[1]
    lib = runtime.get_lib()
    if lib is not None and coeff.flags.c_contiguous:
        import ctypes

        bitmap = np.empty((nb, 8), np.uint8)
        cap = coeff.size
        vals = np.empty(cap, np.int16)
        n = lib.zpix_pack_sparse(
            coeff.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            nb,
            bitmap.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            vals.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            cap,
        )
        if n >= 0:
            return bitmap, vals[:n].copy()
    flat = coeff.reshape(nb, 64)
    mask = flat != 0
    return np.packbits(mask, axis=1), flat[mask].astype(np.int16)


def _unpack_sparse_graph(jnp, bitmap, vals, bv: int, bh: int):
    """[B, nb, 8] uint8 + [B, maxnnz] int16 -> [B, bv, bh, 64] int32."""
    b = bitmap.shape[0]
    nb = bv * bh
    bits = jnp.unpackbits(bitmap.reshape(b, nb * 8), axis=-1)  # [B, nb*64]
    bits = bits.astype(jnp.int32)
    idx = jnp.cumsum(bits, axis=-1) - 1
    idx = jnp.clip(idx, 0, vals.shape[1] - 1)
    gathered = jnp.take_along_axis(vals, idx, axis=-1).astype(jnp.int32)
    coeff = jnp.where(bits == 1, gathered, 0)
    return coeff.reshape(b, bv, bh, 64)


def _apply_perm(jnp, coeff, perm, bv, bx):
    if perm is None:
        return coeff
    return jnp.take(coeff.reshape(coeff.shape[0], -1, 64), perm, axis=1).reshape(
        coeff.shape[0], bv, bx, 64
    )


def _ycbcr_graph_packed(
    bm_y, v_y, bm_cb, v_cb, bm_cr, v_cr, qy, qcb, qcr, perm_y, perm_c,
    *, height, width, ratio, by, bx, cby, cbx,
):
    """Packed-transfer variant of _ycbcr_graph (static block-grid dims).

    perm_y / perm_c (grid->stream gathers, or None) reorder blocks emitted
    in MCU-interleaved stream order by the native front-end.
    """
    import jax.numpy as jnp

    cy = _apply_perm(jnp, _unpack_sparse_graph(jnp, bm_y, v_y, by, bx), perm_y, by, bx)
    ccb = _apply_perm(
        jnp, _unpack_sparse_graph(jnp, bm_cb, v_cb, cby, cbx), perm_c, cby, cbx
    )
    ccr = _apply_perm(
        jnp, _unpack_sparse_graph(jnp, bm_cr, v_cr, cby, cbx), perm_c, cby, cbx
    )
    return _ycbcr_graph(
        cy, ccb, ccr, qy, qcb, qcr, height=height, width=width, ratio=ratio
    )


def decode_batch_ycbcr_packed(
    bm_y, v_y, bm_cb, v_cb, bm_cr, v_cr, qy, qcb, qcr,
    *, height, width, ratio, by, bx, cby, cbx, perm_y=None, perm_c=None,
):
    return _jitted(
        "ycbcr_packed",
        _ycbcr_graph_packed,
        ("height", "width", "ratio", "by", "bx", "cby", "cbx"),
    )(
        bm_y, v_y, bm_cb, v_cb, bm_cr, v_cr, qy, qcb, qcr, perm_y, perm_c,
        height=height, width=width, ratio=ratio, by=by, bx=bx, cby=cby, cbx=cbx,
    )


def _ycbcr_graph_flat(
    buffer, qy, qcb, qcr, perm_y, perm_c,
    *, height, width, ratio, by, bx, cby, cbx, layout, batch,
):
    """Single-transfer variant: one uint8 buffer carved on device.

    layout: static tuple of ("bm"|"val", comp, offset, nbytes) describing
    the NativeBatchFrontEnd flat buffer.
    """
    import jax
    import jax.numpy as jnp

    bms = [None] * 3
    vls = [None] * 3
    for kind, c, off, nbytes in layout:
        seg = jax.lax.slice(buffer, (off,), (off + nbytes,))
        if kind == "bm":
            bms[c] = seg.reshape(batch, -1, 8)
        else:
            vls[c] = jax.lax.bitcast_convert_type(
                seg.reshape(batch, -1, 2), jnp.int16
            )
    cy = _apply_perm(jnp, _unpack_sparse_graph(jnp, bms[0], vls[0], by, bx), perm_y, by, bx)
    ccb = _apply_perm(jnp, _unpack_sparse_graph(jnp, bms[1], vls[1], cby, cbx), perm_c, cby, cbx)
    ccr = _apply_perm(jnp, _unpack_sparse_graph(jnp, bms[2], vls[2], cby, cbx), perm_c, cby, cbx)
    return _ycbcr_graph(
        cy, ccb, ccr, qy, qcb, qcr, height=height, width=width, ratio=ratio
    )


def decode_batch_ycbcr_flat(
    buffer, qy, qcb, qcr,
    *, height, width, ratio, by, bx, cby, cbx, layout, batch,
    perm_y=None, perm_c=None,
):
    return _jitted(
        "ycbcr_flat",
        _ycbcr_graph_flat,
        ("height", "width", "ratio", "by", "bx", "cby", "cbx", "layout", "batch"),
    )(
        buffer, qy, qcb, qcr, perm_y, perm_c,
        height=height, width=width, ratio=ratio,
        by=by, bx=bx, cby=cby, cbx=cbx, layout=layout, batch=batch,
    )


def _pad_vals(vals_list, mult: int = 512):
    """Stack ragged value arrays, padded to a shared multiple-of-mult cap."""
    cap = max(1, max(len(v) for v in vals_list))
    cap = (cap + mult - 1) // mult * mult
    out = np.zeros((len(vals_list), cap), np.int16)
    for i, v in enumerate(vals_list):
        out[i, : len(v)] = v
    return out


class BatchJpegDecoder:
    """Same-shape batched JPEG decoding, optionally sharded over a mesh.

    usage:
        dec = BatchJpegDecoder(mesh)           # mesh from parallel.make_mesh
        rgb = dec.decode([jpeg_bytes, ...])    # [B, H, W, 3] uint8 on device
    """

    def __init__(self, mesh=None, front_end=parse_coefficients, packed: bool = False):
        self.mesh = mesh
        self.front_end = front_end
        self.packed = packed

    def _shard(self, arr):
        if self.mesh is None:
            return arr
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P

        return jax.device_put(arr, NamedSharding(self.mesh, P("batch")))

    def decode(self, datas: list[bytes]):
        from ..utils import metrics, trace

        with trace("jpeg_batch.front_end"):
            fes = [self.front_end(d) for d in datas]
        metrics.count("jpeg_batch.images", len(datas))
        metrics.count(
            "jpeg_batch.megapixels",
            sum(fe.width * fe.height for fe in fes) / 1e6,
        )
        f0 = fes[0]
        for fe in fes[1:]:
            if (fe.width, fe.height, fe.ratio, fe.color) != (
                f0.width, f0.height, f0.ratio, f0.color
            ):
                raise ValueError(
                    "batch images must share (width, height, ratio, color); "
                    "bucket mixed shapes separately"
                )
        if f0.color == "cmyk?":
            from ..errors import UnsupportedError

            raise UnsupportedError(
                "jpeg: unknown color model: 4-component color model"
            )
        if f0.ncomp == 1:
            cy = self._shard(np.stack([fe.coeffs[0] for fe in fes]))
            qy = self._shard(np.stack([fe.quants[0] for fe in fes]))
            return decode_batch_gray(cy, qy, height=f0.height, width=f0.width)
        if f0.color in ("rgb", "ycck", "cmyk"):
            coeffs = [
                self._shard(np.stack([fe.coeffs[c] for fe in fes]))
                for c in range(f0.ncomp)
            ]
            quants = [
                self._shard(np.stack([fe.quants[c] for fe in fes]))
                for c in range(f0.ncomp)
            ]
            if f0.color == "rgb":
                return _jitted("rgb", _rgb_graph, ("height", "width", "ratio"))(
                    *coeffs, *quants,
                    height=f0.height, width=f0.width, ratio=f0.ratio,
                )
            if f0.color == "ycck":
                return _jitted("ycck", _ycck_graph, ("height", "width", "ratio"))(
                    *coeffs, *quants,
                    height=f0.height, width=f0.width, ratio=f0.ratio,
                )
            sub = tuple(hv != f0.hv[0] for hv in f0.hv)
            return _jitted("cmyk", _cmyk_graph, ("height", "width", "sub"))(
                *coeffs, *quants,
                height=f0.height, width=f0.width, sub=sub,
            )
        qy = self._shard(np.stack([fe.quants[0] for fe in fes]))
        qcb = self._shard(np.stack([fe.quants[1] for fe in fes]))
        qcr = self._shard(np.stack([fe.quants[2] for fe in fes]))
        if self.packed:
            packs = [[pack_sparse(fe.coeffs[c]) for fe in fes] for c in range(3)]
            args = []
            for c in range(3):
                args.append(self._shard(np.stack([p[0] for p in packs[c]])))
                args.append(self._shard(_pad_vals([p[1] for p in packs[c]])))
            by, bx = fes[0].coeffs[0].shape[:2]
            cby, cbx = fes[0].coeffs[1].shape[:2]
            return decode_batch_ycbcr_packed(
                *args, qy, qcb, qcr,
                height=f0.height, width=f0.width, ratio=f0.ratio,
                by=by, bx=bx, cby=cby, cbx=cbx,
            )
        cy = self._shard(np.stack([fe.coeffs[0] for fe in fes]))
        ccb = self._shard(np.stack([fe.coeffs[1] for fe in fes]))
        ccr = self._shard(np.stack([fe.coeffs[2] for fe in fes]))
        return decode_batch_ycbcr_to_rgb(
            cy, ccb, ccr, qy, qcb, qcr,
            height=f0.height, width=f0.width, ratio=f0.ratio,
        )
