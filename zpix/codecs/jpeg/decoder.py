"""JPEG decoder: marker loop, entropy front-end, batched reconstruction.

Architecture: the bit-serial entropy decode (Huffman + progressive
refinement) runs as a host-side scan producing per-component coefficient
tensors [blocks_v, blocks_h, 64]; the dense back-end (dequant + exact Wang
IDCT + level shift) then runs *batched* over every block at once
(zpix/ops/idct.py), which is the layout the device pipeline consumes.
This inverts the reference's per-block reconstructBlock loop
(/root/reference/src/jpeg/decoder.zig:1553-1634) without changing a single
output sample.

Entropy/stream semantics mirror the reference exactly:
  * marker loop with liberal extraneous-byte skipping (decoder.zig:220-373)
  * byte stuffing FF00 + unread bookkeeping (decoder.zig:712-749, :479-487)
  * Huffman LUT fast path + bit-by-bit slow path (decoder.zig:909-970)
  * RECEIVE/EXTEND (decoder.zig:1115-1134)
  * interleaved vs non-interleaved block traversal (decoder.zig:1294-1337)
  * progressive spectral selection / successive approximation + EOB runs
    (decoder.zig:1362-1412, :1459-1549)
  * restart markers with findRst resync (decoder.zig:1432-1452, :1671-1705)
"""

from __future__ import annotations

import numpy as np

from ...errors import BadRSTMarker, FormatError, UnexpectedEof, UnsupportedError
from ...image import (
    CMYKImage,
    Config,
    GrayImage,
    RGBAImage,
    YCbCrImage,
)
from ...image.model import chroma_dims
from ...image.util import draw_ycbcr
from ...ops.idct import idct_batch
from .tables import MAX_CODE_LENGTH, UNZIG, HuffTable

MAX_COMPONENTS = 4
DC_TABLE = 0
AC_TABLE = 1

M_SOF0 = 0xC0
M_SOF1 = 0xC1
M_SOF2 = 0xC2
M_DHT = 0xC4
M_RST0 = 0xD0
M_RST7 = 0xD7
M_SOI = 0xD8
M_EOI = 0xD9
M_SOS = 0xDA
M_DQT = 0xDB
M_DRI = 0xDD
M_COM = 0xFE
M_APP0 = 0xE0
M_APP14 = 0xEE
M_APP15 = 0xEF

ADOBE_UNKNOWN = 0
ADOBE_YCBCR = 1
ADOBE_YCBCRK = 2


class _MissingFF00(FormatError):
    """0xFF not followed by 0x00 in entropy data (decoder.zig:723-729).

    Caught by decode_huffman's fast path as end-of-segment; anywhere else it
    propagates as a format error, matching the reference's error.MissingFF00.
    """


class _ConfigOnly(Exception):
    """Internal signal: header parsing finished for decode_config."""


class Component:
    __slots__ = ("h", "v", "id", "tq")

    def __init__(self):
        self.h = 0
        self.v = 0
        self.id = 0
        self.tq = 0


class Decoder:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        # Bit accumulator (decoder.zig:90-97).
        self.bits_a = 0
        self.bits_m = 0
        self.bits_n = 0
        # Unread bookkeeping for byte-stuffed overshoot (decoder.zig:107-116).
        self.num_unreadable = 0

        self.width = 0
        self.height = 0
        self.num_components = 0
        self.restart_interval = 0
        self.baseline = False
        self.progressive = False
        self.jfif = False
        self.adobe_transform_valid = False
        self.adobe_transform = ADOBE_UNKNOWN
        self.eob_run = 0

        self.component = [Component() for _ in range(MAX_COMPONENTS)]
        self.huff = [[HuffTable() for _ in range(4)] for _ in range(2)]
        self.huff_set = [[False] * 4 for _ in range(2)]
        self.quant = [np.zeros(64, np.int32) for _ in range(4)]  # zig-zag order

        # Per-component coefficient tensors [blocks_v, blocks_h, 64] and
        # output planes; allocated by _make_img.
        self.coeff: list[np.ndarray | None] = [None] * MAX_COMPONENTS
        self.planes: list[np.ndarray | None] = [None] * MAX_COMPONENTS
        self.mxx = 0
        self.myy = 0
        self.img_allocated = False
        # When set, skip reconstruction: the batched pipeline
        # (zpix/parallel/batch.py) consumes raw coefficients instead.
        self.collect_only = False

    # ------------------------------------------------------------------
    # Byte/bit input (decoder.zig:400-487, :712-749, :975-1022)
    # ------------------------------------------------------------------

    def _unread_prologue(self):
        """readFull/ignore prologue (decoder.zig:417-423)."""
        if self.num_unreadable > 0:
            if self.bits_n >= 8:
                self._unread_byte_stuffed_byte()
            self.num_unreadable = 0

    def _unread_byte_stuffed_byte(self):
        self.pos -= self.num_unreadable
        self.num_unreadable = 0
        if self.bits_n >= 8:
            self.bits_a >>= 8
            self.bits_n -= 8
            self.bits_m >>= 8

    def read_byte(self) -> int:
        if self.pos >= len(self.data):
            raise UnexpectedEof("jpeg: unexpected EOF")
        b = self.data[self.pos]
        self.pos += 1
        self.num_unreadable = 0
        return b

    def read_full(self, n: int) -> bytes:
        self._unread_prologue()
        if self.pos + n > len(self.data):
            raise UnexpectedEof("jpeg: unexpected EOF")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def ignore(self, n: int) -> None:
        self._unread_prologue()
        if self.pos + n > len(self.data):
            raise UnexpectedEof("jpeg: unexpected EOF")
        self.pos += n

    def read_byte_stuffed_byte(self) -> int:
        data, pos = self.data, self.pos
        if pos >= len(data):
            self.num_unreadable = 0
            raise UnexpectedEof("jpeg: unexpected EOF")
        x = data[pos]
        self.pos = pos + 1
        self.num_unreadable = 1
        if x != 0xFF:
            return x
        if self.pos >= len(data):
            self.num_unreadable = 0
            raise UnexpectedEof("jpeg: unexpected EOF")
        if data[self.pos] != 0x00:
            # Leave num_unreadable=1 so unread restores to the 0xFF
            # (decoder.zig:719-724 fast path).
            raise _MissingFF00()
        self.pos += 1
        self.num_unreadable = 2
        return 0xFF

    def ensure_n_bits(self, n: int) -> None:
        while True:
            c = self.read_byte_stuffed_byte()
            self.bits_a = ((self.bits_a << 8) | c) & 0xFFFFFFFF
            self.bits_n += 8
            if self.bits_m == 0:
                self.bits_m = 1 << 7
            else:
                self.bits_m = (self.bits_m << 8) & 0xFFFFFFFF
            if self.bits_n >= n:
                return

    def decode_bit(self) -> bool:
        if self.bits_n == 0:
            self.ensure_n_bits(1)
        ret = (self.bits_a & self.bits_m) != 0
        self.bits_n -= 1
        self.bits_m >>= 1
        return ret

    def decode_bits(self, n: int) -> int:
        if self.bits_n < n:
            self.ensure_n_bits(n)
        ret = (self.bits_a >> (self.bits_n - n)) & ((1 << n) - 1)
        self.bits_n -= n
        self.bits_m >>= n
        return ret

    def decode_huffman(self, h: HuffTable) -> int:
        if h.num_codes == 0:
            raise FormatError("jpeg: uninitialized Huffman table")

        if self.bits_n < 8:
            try:
                self.ensure_n_bits(8)
            except _MissingFF00:
                if self.num_unreadable != 0:
                    self._unread_byte_stuffed_byte()
                return self._decode_huffman_slow(h)
            except UnexpectedEof:
                raise
        v = h.lut[(self.bits_a >> (self.bits_n - 8)) & 0xFF]
        if v != 0:
            n = (v & 0xFF) - 1
            self.bits_n -= n
            self.bits_m >>= n
            return v >> 8
        return self._decode_huffman_slow(h)

    def _decode_huffman_slow(self, h: HuffTable) -> int:
        code = 0
        for i in range(MAX_CODE_LENGTH):
            if self.bits_n == 0:
                self.ensure_n_bits(1)
            if self.bits_a & self.bits_m:
                code |= 1
            self.bits_n -= 1
            self.bits_m >>= 1
            if code <= h.max_codes[i]:
                return h.vals[h.vals_indices[i] + code - h.min_codes[i]]
            code <<= 1
        raise FormatError("jpeg: bad Huffman code")

    def receive_extend(self, t: int) -> int:
        if self.bits_n < t:
            self.ensure_n_bits(t)
        self.bits_n -= t
        self.bits_m >>= t
        threshold = 1 << t
        value = (self.bits_a >> self.bits_n) & (threshold - 1)
        if value < (threshold >> 1):
            value += ((-1) << t) + 1
        return value

    # ------------------------------------------------------------------
    # Segment processing (decoder.zig:490-709, :1026-1111)
    # ------------------------------------------------------------------

    def process_sof(self, n: int) -> None:
        if self.num_components != 0:
            raise FormatError("jpeg: multiple SOF markers")
        if n == 6 + 3 * 1:
            self.num_components = 1
        elif n == 6 + 3 * 3:
            self.num_components = 3
        elif n == 6 + 3 * 4:
            self.num_components = 4
        else:
            raise UnsupportedError("jpeg: number of components")
        tmp = self.read_full(n)
        if tmp[0] != 8:
            raise UnsupportedError("jpeg: precision")
        self.height = (tmp[1] << 8) | tmp[2]
        self.width = (tmp[3] << 8) | tmp[4]
        if tmp[5] != self.num_components:
            raise FormatError("jpeg: SOF has wrong length")

        for i in range(self.num_components):
            comp = self.component[i]
            comp.id = tmp[6 + 3 * i]
            for j in range(i):
                if comp.id == self.component[j].id:
                    raise FormatError("jpeg: repeated component identifier")
            comp.tq = tmp[8 + 3 * i]
            if comp.tq > 3:
                raise FormatError("jpeg: bad Tq value")
            hv = tmp[7 + 3 * i]
            h, v = hv >> 4, hv & 0x0F
            if h < 1 or h > 4 or v < 1 or v > 4 or h == 3 or v == 3:
                raise UnsupportedError("jpeg: luma/chroma subsampling ratio")
            if self.num_components == 1:
                # Single component: effectively always (1, 1)
                # (decoder.zig:547-561).
                h, v = 1, 1
            elif self.num_components == 3:
                if i == 0:
                    if v == 4:
                        raise UnsupportedError("jpeg: luma/chroma subsampling ratio")
                elif i == 1:
                    if self.component[0].h % h != 0 or self.component[0].v % v != 0:
                        raise UnsupportedError("jpeg: luma/chroma subsampling ratio")
                elif i == 2:
                    if self.component[1].h != h or self.component[1].v != v:
                        raise UnsupportedError("jpeg: luma/chroma subsampling ratio")
            else:  # 4 components (decoder.zig:595-611)
                if i == 0:
                    if hv != 0x11 and hv != 0x22:
                        raise UnsupportedError("jpeg: luma/chroma subsampling ratio")
                elif i in (1, 2):
                    if hv != 0x11:
                        raise UnsupportedError("jpeg: luma/chroma subsampling ratio")
                else:
                    if self.component[0].h != h or self.component[0].v != v:
                        raise UnsupportedError("jpeg: luma/chroma subsampling ratio")
            comp.h = h
            comp.v = v

    def process_dqt(self, n: int) -> None:
        while n > 0:
            n -= 1
            qi = self.read_byte()
            tq = qi & 0x0F
            if tq > 3:
                raise FormatError("jpeg: bad Tq value")
            pq = qi >> 4
            if pq == 0:
                if n < 64:
                    break
                n -= 64
                vals = self.read_full(64)
                self.quant[tq] = np.frombuffer(vals, np.uint8).astype(np.int32)
            elif pq == 1:
                if n < 128:
                    break
                n -= 128
                vals = self.read_full(128)
                arr = np.frombuffer(vals, np.uint8).astype(np.int32)
                self.quant[tq] = (arr[0::2] << 8) | arr[1::2]
            else:
                raise FormatError("jpeg: bad Pq value")
        if n != 0:
            raise FormatError("jpeg: DQT has wrong length")

    def process_dht(self, n: int) -> None:
        while n > 0:
            if n < MAX_CODE_LENGTH + 1:
                raise FormatError("jpeg: DHT has wrong length")
            tmp = self.read_full(MAX_CODE_LENGTH + 1)
            tc = tmp[0] >> 4
            if tc > 1:
                raise FormatError("jpeg: bad Tc value")
            th = tmp[0] & 0x0F
            if th > 3 or (self.baseline and th > 1):
                raise FormatError("jpeg: bad Th value")
            counts = list(tmp[1:])
            total = sum(counts)
            if total == 0:
                raise FormatError("jpeg: Huffman table has zero length")
            if total > 256:
                raise FormatError("jpeg: Huffman table has excessive length")
            n -= total + MAX_CODE_LENGTH + 1
            if n < 0:
                raise FormatError("jpeg: DHT has wrong length")
            vals = self.read_full(total)
            self.huff[tc][th].build(counts, vals)
            self.huff_set[tc][th] = True

    def process_dri(self, n: int) -> None:
        if n != 2:
            raise FormatError("jpeg: DRI has wrong length")
        tmp = self.read_full(2)
        self.restart_interval = (tmp[0] << 8) | tmp[1]

    def process_app0(self, n: int) -> None:
        if n < 5:
            return self.ignore(n)
        tmp = self.read_full(5)
        self.jfif = tmp[:5] == b"JFIF\x00"
        if n > 5:
            self.ignore(n - 5)

    def process_app14(self, n: int) -> None:
        if n < 12:
            return self.ignore(n)
        tmp = self.read_full(12)
        if tmp[:5] == b"Adobe":
            self.adobe_transform_valid = True
            self.adobe_transform = tmp[11]
        if n > 12:
            self.ignore(n - 12)

    def is_rgb(self) -> bool:
        if self.jfif:
            return False
        if self.adobe_transform_valid and self.adobe_transform == ADOBE_UNKNOWN:
            return True
        return (
            self.component[0].id == ord("R")
            and self.component[1].id == ord("G")
            and self.component[2].id == ord("B")
        )

    # ------------------------------------------------------------------
    # Image allocation (decoder.zig:1708-1783)
    # ------------------------------------------------------------------

    def _make_img(self, mxx: int, myy: int) -> None:
        self.mxx, self.myy = mxx, myy
        for i in range(self.num_components):
            comp = self.component[i]
            bh = mxx * comp.h
            bv = myy * comp.v
            self.planes[i] = np.zeros((8 * bv, 8 * bh), np.uint8)
        self.img_allocated = True

    def _ensure_coeff(self, c: int) -> None:
        if self.coeff[c] is None:
            comp = self.component[c]
            self.coeff[c] = np.zeros(
                (self.myy * comp.v, self.mxx * comp.h, 64), np.int32
            )

    # ------------------------------------------------------------------
    # Scan processing (decoder.zig:1148-1455)
    # ------------------------------------------------------------------

    def process_sos(self, n: int) -> None:
        if self.num_components == 0:
            raise FormatError("jpeg: missing SOS marker")
        if n < 6 or 4 + 2 * self.num_components < n or n % 2 != 0:
            raise FormatError("jpeg: SOS has wrong length")
        tmp = self.read_full(n)
        n_comp = tmp[0]
        if n != 4 + 2 * n_comp:
            raise FormatError("jpeg: SOS has wrong length")

        scan_ids = [0] * n_comp
        scan_td = [0] * n_comp
        scan_ta = [0] * n_comp
        total_hv = 0
        for i in range(n_comp):
            cs = tmp[1 + 2 * i]
            comp_index = None
            for j in range(self.num_components):
                if cs == self.component[j].id:
                    comp_index = j
                    break
            if comp_index is None:
                raise FormatError("jpeg: unknown component selector")
            scan_ids[i] = comp_index
            for j in range(i):
                if scan_ids[i] == scan_ids[j]:
                    raise FormatError("jpeg: repeated component identifier")
            total_hv += self.component[comp_index].h * self.component[comp_index].v
            scan_td[i] = tmp[2 + 2 * i] >> 4
            if scan_td[i] > 3 or (self.baseline and scan_td[i] > 1):
                raise FormatError("jpeg: bad Td value")
            scan_ta[i] = tmp[2 + 2 * i] & 0x0F
            if scan_ta[i] > 3 or (self.baseline and scan_ta[i] > 1):
                raise FormatError("jpeg: bad Ta value")
        if self.num_components > 1 and total_hv > 10:
            raise FormatError("jpeg: total sampling factors too large")

        zig_start, zig_end, ah, al = 0, 63, 0, 0
        if self.progressive:
            zig_start = tmp[1 + 2 * n_comp]
            zig_end = tmp[2 + 2 * n_comp]
            ah = tmp[3 + 2 * n_comp] >> 4
            al = tmp[3 + 2 * n_comp] & 0x0F
            if (zig_start == 0 and zig_end != 0) or zig_start > zig_end or zig_end >= 64:
                raise FormatError("jpeg: bad spectral selection bounds")
            if zig_start != 0 and n_comp != 1:
                raise FormatError(
                    "jpeg: progressive AC coefficients for more than one component"
                )
            if ah != 0 and ah != al + 1:
                raise FormatError("jpeg: bad successive approximation values")

        h0 = self.component[0].h
        v0 = self.component[0].v
        mxx = (self.width + 8 * h0 - 1) // (8 * h0)
        myy = (self.height + 8 * v0 - 1) // (8 * v0)
        if not self.img_allocated:
            self._make_img(mxx, myy)
        for i in range(n_comp):
            self._ensure_coeff(scan_ids[i])

        self.bits_a = self.bits_m = self.bits_n = 0
        self.num_unreadable = 0

        if self._native_scan(
            scan_ids, scan_td, scan_ta, n_comp, mxx, myy,
            zig_start, zig_end, ah, al,
        ):
            return

        mcu = 0
        expected_rst = M_RST0
        block_count = 0
        dc = [0] * MAX_COMPONENTS
        unzig = UNZIG
        width, height = self.width, self.height

        # Record which blocks each scan touched for batched reconstruction.
        touched: list[set] = [set() for _ in range(MAX_COMPONENTS)]

        for my in range(myy):
            for mx in range(mxx):
                for k in range(n_comp):
                    c_index = scan_ids[k]
                    comp = self.component[c_index]
                    hi, vi = comp.h, comp.v
                    coeff_c = self.coeff[c_index]
                    for j in range(hi * vi):
                        if n_comp != 1:
                            bx = hi * mx + (j % hi)
                            by = vi * my + (j // hi)
                        else:
                            bx = block_count % (mxx * hi)
                            by = block_count // (mxx * hi)
                            block_count += 1
                            if bx * 8 >= width or by * 8 >= height:
                                continue

                        b = coeff_c[by, bx]

                        if ah != 0:
                            self._refine(
                                b,
                                self.huff[AC_TABLE][scan_ta[k]],
                                zig_start,
                                zig_end,
                                1 << al,
                            )
                        else:
                            zig = zig_start
                            if zig == 0:
                                zig += 1
                                value = self.decode_huffman(
                                    self.huff[DC_TABLE][scan_td[k]]
                                )
                                if value > 16:
                                    raise UnsupportedError(
                                        "jpeg: excessive DC component"
                                    )
                                dc_delta = self.receive_extend(value)
                                dc[c_index] += dc_delta
                                b[0] = dc[c_index] << al

                            if zig <= zig_end and self.eob_run > 0:
                                self.eob_run -= 1
                            else:
                                huff = self.huff[AC_TABLE][scan_ta[k]]
                                while zig <= zig_end:
                                    value = self.decode_huffman(huff)
                                    val0 = value >> 4
                                    val1 = value & 0x0F
                                    if val1 != 0:
                                        zig += val0
                                        if zig > zig_end:
                                            break
                                        ac = self.receive_extend(val1)
                                        b[unzig[zig]] = ac << al
                                    else:
                                        if val0 != 0x0F:
                                            self.eob_run = 1 << val0
                                            if val0 != 0:
                                                self.eob_run |= self.decode_bits(val0)
                                            self.eob_run -= 1
                                            break
                                        zig += 0x0F
                                    zig += 1

                        touched[c_index].add((by, bx))

                mcu += 1
                if (
                    self.restart_interval > 0
                    and mcu % self.restart_interval == 0
                    and mcu < mxx * myy
                ):
                    tmp2 = self.read_full(2)
                    if tmp2[0] != 0xFF or tmp2[1] != expected_rst:
                        self._find_rst(expected_rst, tmp2)
                    expected_rst += 1
                    if expected_rst == M_RST7 + 1:
                        expected_rst = M_RST0
                    self.bits_a = self.bits_m = self.bits_n = 0
                    self.num_unreadable = 0
                    dc = [0] * MAX_COMPONENTS
                    self.eob_run = 0

        if not self.progressive and not self.collect_only:
            # Sequential: batched dequant + IDCT + store for this scan's
            # blocks (the reference reconstructs per block inline,
            # decoder.zig:1426; results are identical).
            for c_index in range(MAX_COMPONENTS):
                if touched[c_index]:
                    self._reconstruct_blocks(c_index, sorted(touched[c_index]))

    def _native_scan(
        self, scan_ids, scan_td, scan_ta, n_comp, mxx, myy,
        zig_start, zig_end, ah, al,
    ) -> bool:
        """Run the scan loop in the native runtime if available.

        Returns True when the native path fully handled the scan (including
        sequential reconstruction).  Error codes map onto the same
        exceptions the Python scan raises, so behavior is identical.
        """
        from ... import runtime

        lib = runtime.get_lib()
        if lib is None:
            return False
        import ctypes

        huff_arr = (runtime.HuffTableC * 8)()
        for tc in range(2):
            for th in range(4):
                if self.huff_set[tc][th]:
                    h = self.huff[tc][th]
                    c = huff_arr[tc * 4 + th]
                    c.lut[:] = h.lut
                    c.min_codes[:] = h.min_codes
                    c.max_codes[:] = h.max_codes
                    c.vals_indices[:] = h.vals_indices
                    c.vals[:] = h.vals
                    c.num_codes = h.num_codes

        scan_arr = (runtime.ScanCompC * n_comp)()
        coeff_ptrs = (ctypes.POINTER(ctypes.c_int32) * n_comp)()
        for k in range(n_comp):
            ci = scan_ids[k]
            comp = self.component[ci]
            scan_arr[k].c_index = ci
            scan_arr[k].dc_table = scan_td[k]
            scan_arr[k].ac_table = scan_ta[k]
            scan_arr[k].h = comp.h
            scan_arr[k].v = comp.v
            scan_arr[k].bh = mxx * comp.h
            coeff_ptrs[k] = self.coeff[ci].ctypes.data_as(
                ctypes.POINTER(ctypes.c_int32)
            )

        eob = ctypes.c_uint16(self.eob_run)
        pos_out = ctypes.c_int64(0)
        bits_n_out = ctypes.c_int32(0)
        unread_out = ctypes.c_int32(0)
        rc = lib.zpix_decode_scan(
            self.data,
            len(self.data),
            self.pos,
            huff_arr,
            scan_arr,
            n_comp,
            mxx,
            myy,
            self.width,
            self.height,
            self.restart_interval,
            zig_start,
            zig_end,
            ah,
            al,
            1 if self.progressive else 0,
            coeff_ptrs,
            ctypes.byref(eob),
            ctypes.byref(pos_out),
            ctypes.byref(bits_n_out),
            ctypes.byref(unread_out),
        )
        if rc == runtime.ERR_EOF:
            raise UnexpectedEof("jpeg: unexpected EOF")
        if rc == runtime.ERR_MISSING_FF00:
            raise _MissingFF00("jpeg: missing 0xff00 sequence")
        if rc == runtime.ERR_BAD_HUFFMAN:
            raise FormatError("jpeg: bad Huffman code")
        if rc == runtime.ERR_UNINIT_TABLE:
            raise FormatError("jpeg: uninitialized Huffman table")
        if rc == runtime.ERR_EXCESSIVE_DC:
            raise UnsupportedError("jpeg: excessive DC component")
        if rc == runtime.ERR_BAD_RST:
            raise BadRSTMarker("jpeg: bad RST marker")
        if rc == runtime.ERR_UNEXPECTED_CODE:
            raise FormatError("jpeg: unexpected Huffman code")
        if rc == runtime.ERR_TOO_MANY_COEFFS:
            raise FormatError("jpeg: too many coefficients")
        if rc != 0:
            # Unknown code: coefficients may be partially written, so a
            # fallback re-run is not safe — surface the failure.
            raise FormatError(f"jpeg: native scan error {rc}")

        self.pos = pos_out.value
        self.bits_n = bits_n_out.value
        self.bits_a = self.bits_m = 0
        self.num_unreadable = unread_out.value
        self.eob_run = eob.value

        if not self.progressive and not self.collect_only:
            h8 = (self.height + 7) // 8
            w8 = (self.width + 7) // 8
            for k in range(n_comp):
                ci = scan_ids[k]
                comp = self.component[ci]
                bv, bh = myy * comp.v, mxx * comp.h
                if n_comp == 1:
                    bv, bh = min(bv, h8), min(bh, w8)
                positions = [(by, bx) for by in range(bv) for bx in range(bh)]
                self._reconstruct_blocks(ci, positions)
        return True

    def _refine(self, b: np.ndarray, h: HuffTable, zig_start: int, zig_end: int, delta: int) -> None:
        """Successive approximation refinement (decoder.zig:1459-1518)."""
        if zig_start == 0:
            if zig_end != 0:
                raise FormatError("jpeg: bad spectral selection bounds")
            if self.decode_bit():
                b[0] |= delta
            return

        zig = zig_start
        if self.eob_run == 0:
            while zig <= zig_end:
                z = 0
                value = self.decode_huffman(h)
                val0 = value >> 4
                val1 = value & 0x0F
                if val1 == 0:
                    if val0 != 0x0F:
                        self.eob_run = 1 << val0
                        if val0 != 0:
                            self.eob_run |= self.decode_bits(val0)
                        break
                elif val1 == 1:
                    z = delta
                    if not self.decode_bit():
                        z = -z
                else:
                    raise FormatError("jpeg: unexpected Huffman code")

                zig = self._refine_non_zeroes(b, zig, zig_end, val0, delta)
                if zig > zig_end:
                    raise FormatError("jpeg: too many coefficients")
                if z != 0:
                    b[UNZIG[zig]] = z
                zig += 1

        if self.eob_run > 0:
            self.eob_run -= 1
            self._refine_non_zeroes(b, zig, zig_end, -1, delta)

    def _refine_non_zeroes(self, b: np.ndarray, zig: int, zig_end: int, nz: int, delta: int) -> int:
        """Correction bits on existing coefficients (decoder.zig:1522-1549)."""
        unzig = UNZIG
        while zig <= zig_end:
            u = unzig[zig]
            if b[u] == 0:
                if nz == 0:
                    break
                nz -= 1
            else:
                if self.decode_bit():
                    if b[u] >= 0:
                        b[u] += delta
                    else:
                        b[u] -= delta
            zig += 1
        return zig

    def _find_rst(self, expected_rst: int, tmp2: bytes) -> None:
        """Resync to the expected RST marker (decoder.zig:1671-1705)."""
        t0, t1 = tmp2[0], tmp2[1]
        while True:
            i = 0
            if t0 == 0xFF:
                if t1 == expected_rst:
                    return
                elif t1 == 0xFF:
                    i = 1
                elif t1 != 0x00:
                    raise BadRSTMarker("jpeg: bad RST marker")
            elif t1 == 0xFF:
                t0 = 0xFF
                i = 1
            nxt = self.read_full(2 - i)
            if i == 1:
                t1 = nxt[0]
            else:
                t0, t1 = nxt[0], nxt[1]

    # ------------------------------------------------------------------
    # Batched reconstruction (decoder.zig:1553-1661, vectorized)
    # ------------------------------------------------------------------

    def _reconstruct_blocks(self, c_index: int, positions) -> None:
        comp = self.component[c_index]
        coeff = self.coeff[c_index]
        plane = self.planes[c_index]
        pos = np.asarray(positions, np.int64)
        bys, bxs = pos[:, 0], pos[:, 1]

        qzig = self.quant[comp.tq]
        qnat = np.empty(64, np.int32)
        qnat[UNZIG] = qzig  # qnat[unzig[z]] = qt[z] (decoder.zig:1564-1567)

        blocks = coeff[bys, bxs].astype(np.int32) * qnat
        out = idct_batch(blocks.reshape(-1, 8, 8))
        pix = np.clip(out + 128, 0, 255).astype(np.uint8)

        bv, bh = plane.shape[0] // 8, plane.shape[1] // 8
        view = plane.reshape(bv, 8, bh, 8)
        view[bys, :, bxs, :] = pix

    def _reconstruct_progressive(self) -> None:
        """Final pass over in-image blocks (decoder.zig:1636-1661)."""
        h0 = self.component[0].h
        v0 = self.component[0].v
        for i in range(self.num_components):
            if self.coeff[i] is None:
                continue
            comp = self.component[i]
            v = 8 * (v0 // comp.v)
            h = 8 * (h0 // comp.h)
            positions = [
                (by, bx)
                for by in range((self.height + v - 1) // v)
                for bx in range((self.width + h - 1) // h)
            ]
            if positions:
                self._reconstruct_blocks(i, positions)

    # ------------------------------------------------------------------
    # Output assembly (decoder.zig:357-373, :751-902)
    # ------------------------------------------------------------------

    def _subsample_ratio(self) -> str:
        h0, v0 = self.component[0].h, self.component[0].v
        h_ratio = h0 // self.component[1].h
        v_ratio = v0 // self.component[1].v
        return {
            0x11: "444",
            0x12: "440",
            0x21: "422",
            0x22: "420",
            0x41: "411",
            0x42: "410",
        }[(h_ratio << 4) | v_ratio]

    def _ycbcr_image(self) -> YCbCrImage:
        ratio = self._subsample_ratio()
        w, h = self.width, self.height
        cw, ch = chroma_dims(w, h, ratio)
        return YCbCrImage(
            self.planes[0][:h, :w],
            self.planes[1][:ch, :cw],
            self.planes[2][:ch, :cw],
            ratio,
        )

    def _convert_to_rgb(self) -> RGBAImage:
        """Interleave Y/Cb/Cr planes as R/G/B (decoder.zig:751-783)."""
        img = self._ycbcr_image()
        g, b = img.upsampled_cbcr()
        pix = np.empty((self.height, self.width, 4), np.uint8)
        pix[..., 0] = img.y
        pix[..., 1] = g
        pix[..., 2] = b
        pix[..., 3] = 255
        return RGBAImage(pix)

    def _apply_black(self) -> CMYKImage:
        """CMYK/YCCK assembly (decoder.zig:792-902)."""
        if not self.adobe_transform_valid:
            raise UnsupportedError(
                "jpeg: unknown color model: 4-component color model"
            )
        w, h = self.width, self.height
        black = self.planes[3]

        if self.adobe_transform != ADOBE_UNKNOWN:
            # YCbCrK: convert YCbCr to RGB (canceling the Adobe inversion),
            # patch in inverted K (decoder.zig:811-846).
            ycbcr = self._ycbcr_image()
            rgba = RGBAImage(np.empty((h, w, 4), np.uint8))
            draw_ycbcr(rgba, ycbcr)
            rgba.pix[..., 3] = 255 - black[:h, :w]
            return CMYKImage(rgba.pix)

        # Raw CMYK: interleave four (possibly subsampled) planes with
        # 255-v inversion (decoder.zig:852-901).
        ratio = self._subsample_ratio()
        cw, ch = chroma_dims(w, h, ratio)
        sources = [
            self.planes[0][:h, :w],
            self.planes[1][:ch, :cw],
            self.planes[2][:ch, :cw],
            black[:h, :w],
        ]
        pix = np.empty((h, w, 4), np.uint8)
        for t in range(4):
            comp = self.component[t]
            subsample = (
                comp.h != self.component[0].h or comp.v != self.component[0].v
            )
            src = sources[t]
            if subsample:
                rows = np.arange(h) >> 1
                cols = np.arange(w) >> 1
                pix[..., t] = 255 - src[np.ix_(rows, cols)]
            else:
                pix[..., t] = 255 - src[:h, :w]
        return CMYKImage(pix)

    # ------------------------------------------------------------------
    # Marker loop (decoder.zig:220-373)
    # ------------------------------------------------------------------

    def decode_inner(self, config_only: bool):
        tmp = self.read_full(2)
        if tmp[0] != 0xFF or tmp[1] != M_SOI:
            raise FormatError("jpeg: missing SOI marker")

        while True:
            tmp = bytearray(self.read_full(2))
            while tmp[0] != 0xFF:
                # Liberal extraneous-data skipping (decoder.zig:246-269).
                tmp[0] = tmp[1]
                tmp[1] = self.read_byte()
            marker = tmp[1]
            if marker == 0:
                continue
            while marker == 0xFF:
                marker = self.read_byte()
            if marker == M_EOI:
                break
            if M_RST0 <= marker <= M_RST7:
                continue

            ln = self.read_full(2)
            n = ((ln[0] << 8) | ln[1]) - 2
            if n < 0:
                raise FormatError("jpeg: short segment length")

            if marker in (M_SOF0, M_SOF1, M_SOF2):
                self.baseline = marker == M_SOF0
                self.progressive = marker == M_SOF2
                self.process_sof(n)
                if config_only and self.jfif:
                    raise _ConfigOnly()
            elif marker == M_DQT:
                if config_only:
                    self.ignore(n)
                else:
                    self.process_dqt(n)
            elif marker == M_DRI:
                if config_only:
                    self.ignore(n)
                else:
                    self.process_dri(n)
            elif marker == M_DHT:
                if config_only:
                    self.ignore(n)
                else:
                    self.process_dht(n)
            elif marker == M_SOS:
                if config_only:
                    raise _ConfigOnly()
                self.process_sos(n)
            elif marker == M_APP0:
                self.process_app0(n)
            elif marker == M_APP14:
                self.process_app14(n)
            elif (M_APP0 <= marker <= M_APP15) or marker == M_COM:
                self.ignore(n)
            elif marker < 0xC0:
                raise FormatError("jpeg: unknown marker")
            else:
                raise UnsupportedError("jpeg: unsupported marker")

        if self.collect_only:
            if self.coeff[0] is None:
                raise FormatError("jpeg: missing SOS marker")
            return self

        if self.progressive:
            self._reconstruct_progressive()

        if self.num_components == 1 and self.planes[0] is not None:
            return GrayImage(self.planes[0][: self.height, : self.width])
        if self.num_components >= 3 and self.planes[0] is not None:
            if self.num_components == 4:
                return self._apply_black()
            if self.is_rgb():
                return self._convert_to_rgb()
            return self._ycbcr_image()
        raise FormatError("jpeg: missing SOS marker")


def decode(data: bytes):
    return Decoder(data).decode_inner(False)


def decode_config(data: bytes) -> Config:
    d = Decoder(data)
    try:
        d.decode_inner(True)
    except _ConfigOnly:
        pass
    if d.num_components == 1:
        return Config(d.width, d.height, "Gray")
    if d.num_components in (3, 4):
        return Config(d.width, d.height, "YCbCr")
    raise FormatError("jpeg: missing SOI marker")
