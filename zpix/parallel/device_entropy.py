"""On-device baseline-JPEG entropy decode: restart-segment lanes.

The reference decodes the entropy stream bit-serially on one core
(/root/reference/src/jpeg/decoder.zig:1294-1454, decodeHuffman :909-970).
Here the device does it: every restart segment is an independent lane
(restart markers reset the DC predictors and byte-align the stream,
decoder.zig:1432-1452), so a batch of images becomes tens of thousands of
lanes advancing together through one `lax.while_loop`.

The decode is two passes, both scatter-free (see build_decode_fn): an
index pass over segment lanes finds every 8x8 block's bit offset by
decoding only symbol lengths, then a value pass runs one lane per BLOCK
so each lane writes its own [64] coefficient row positionally.  Per step
each lane issues ONE window row-gather; everything else — including the
Huffman decode itself — is branch-free vector math with ZERO gathers:

* Huffman decode exploits the contiguity of canonical code spaces:
  code length by compare-sum against 15 scalar limits, symbol byte by
  bit-plane compare-select (see CmpTables; HuffTable semantics per
  /root/reference/src/jpeg/HuffTable.zig:1-33, baked into the compiled
  program as scalar constants);
* RECEIVE/EXTEND (T.81 F.2.2.1, decoder.zig:1115-1134) is branch-free;
* DC predictors (decoder.zig:1366-1376) are restored after the value
  pass by a segmented cumsum of per-block diffs.

Host work is memcpy-class only: marker walk, FF00 de-stuffing, restart
split (decoder.zig:712-749 semantics), stream/offset upload.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

# Loop-unroll defaults (symbols per while-loop step, window words).  Fat
# steps amortize the per-iteration loop overhead; XLA:CPU compiles of the
# big unrolled bodies are slow, so the test suite dials these down via env
# (tests/conftest.py).  The values are untuned for the GPU.
_DEF_K = int(os.environ.get("ZPIX_ONCHIP_K", "16"))
_DEF_K1 = int(os.environ.get("ZPIX_ONCHIP_K1", "24"))
_DEF_W = int(os.environ.get("ZPIX_ONCHIP_W", "6"))
_DEF_W1 = int(os.environ.get("ZPIX_ONCHIP_W1", "8"))
# window fetch form: per-word full-lane gathers (1) vs one [L, W] row
# gather (0, default) — see _make_window_fetch.
_DEF_SPLIT_WIN = os.environ.get("ZPIX_ONCHIP_SPLIT_WIN", "0") == "1"
# split16 value-pass store: int16 AC + separate int32 DC row (halves the
# hot [64, L2] while-loop carry traffic; exact — AC extend <= 15 bits)
_DEF_I16 = os.environ.get("ZPIX_ONCHIP_I16", "1") == "1"
# pass-1 int16 relative block-ends (auto-disabled for long segments)
_DEF_P1I16 = os.environ.get("ZPIX_ONCHIP_P1I16", "0") == "1"
# pass-1 straggler mitigation: run the index pass as N sequential while
# loops over length-sorted lane groups, so each group's trip count tracks
# its OWN longest restart segment instead of the global one.  The sort
# permutation is data (rides in the packed buffer), so one compiled
# program still covers arbitrary content.  1 = single loop (off).
_DEF_BINS = int(os.environ.get("ZPIX_ONCHIP_BINS", "1"))

from ..codecs.jpeg.tables import UNZIG, HuffTable
from ..errors import FormatError, UnsupportedError

class CmpTables:
    """Gather-free canonical-Huffman decode constants.

    A per-lane gather was the hottest primitive of the old 16-bit-LUT
    decode.  Canonical
    JPEG Huffman code spaces are CONTIGUOUS in 16-bit lookahead space
    (next length's first code = (last code + 1) << 1, see the DHT build
    at /root/reference/src/jpeg/decoder.zig:1093-1109), so:

      len(look16)  = 1 + sum_i [look16 >= lim[i]]        (15 compares)
      invalid     <=> look16 >= lim[15]
      symbol index = A[len] + (look16 >> (16 - len))     (A folds valptr,
                     min_code and this table's base in the concat space)

    and the symbol byte comes from bit-planes of the concatenated vals
    array: bit b of vals[idx] = (plane[b][idx>>5] >> (idx&31)) & 1,
    where plane words are selected by compare-sum — all branch-free
    vector math, ZERO gathers.  Everything here is baked into the
    compiled program as scalar constants.
    """

    __slots__ = (
        "ntab", "lims", "aoff", "planes", "nwords", "total", "bases", "counts"
    )

    def __init__(self, tabs: list[HuffTable]):
        self.ntab = len(tabs)
        bases, total = [], 0
        for t in tabs:
            bases.append(total)
            total += t.num_codes
        self.total = total
        self.bases = tuple(bases)
        self.counts = tuple(t.num_codes for t in tabs)
        self.nwords = max(1, (total + 31) // 32)
        vals_concat = np.zeros(self.nwords * 32, np.uint8)
        for t, b in zip(tabs, bases):
            vals_concat[b : b + t.num_codes] = t.vals[: t.num_codes]
        # bit-planes: plane[b][w] bit i = bit b of vals_concat[w*32+i]
        bits = (
            (vals_concat[None, :] >> np.arange(8)[:, None]) & 1
        ).astype(np.uint64)
        self.planes = tuple(
            tuple(
                int(np.bitwise_or.reduce(bits[b, w * 32 : (w + 1) * 32]
                                         << np.arange(32, dtype=np.uint64)))
                for w in range(self.nwords)
            )
            for b in range(8)
        )
        self.lims, self.aoff = [], []
        for t, base in zip(tabs, bases):
            lim, lims, aoffs = 0, [], []
            a_prev = 0
            for ln in range(1, 17):
                mx = t.max_codes[ln - 1]
                if mx >= 0:
                    lim = (mx + 1) << (16 - ln)
                    a_prev = base + t.vals_indices[ln - 1] - t.min_codes[ln - 1]
                lims.append(lim)
                aoffs.append(a_prev)
            self.lims.append(tuple(lims))
            self.aoff.append(tuple(aoffs))
        self.lims = tuple(self.lims)
        self.aoff = tuple(self.aoff)


@dataclass
class ScanPlan:
    """Host-side prep of a same-geometry baseline JPEG batch."""

    width: int
    height: int
    ncomp: int
    hv: tuple  # ((h,v), ...) per component
    ratio: str
    mxx: int
    myy: int
    bpm: int  # blocks per MCU
    comp_of_slot: tuple  # slot index -> component
    n_mcu: int  # MCUs per image
    seg_mcus: int  # restart interval (MCUs per segment)
    n_segs: int  # segments per image
    quants: list  # [ncomp] np.int32[64] natural order
    cmp: CmpTables  # gather-free decode constants (trace-time consts)
    tid_dc: tuple  # component -> cmp table index for DC
    tid_ac: tuple
    stream: np.ndarray  # uint8, destuffed segments back to back (+pad)
    seg_bit_pos: np.ndarray  # int32 [B*n_segs] absolute bit offsets
    seg_n_mcu: np.ndarray  # int32 [B*n_segs] MCUs in each segment
    max_seg_bits: int  # longest restart segment (bounds pass-1 steps)
    batch: int
    cache_key: tuple = None  # (geometry, tables, dri) bucket for jit reuse
    packed: np.ndarray = None  # stream ++ seg_bit_pos(LE int32): 1 upload
    color: str = "ycbcr"  # gray | ycbcr | rgb | ycck | cmyk


def _parse_headers(data: bytes):
    """Minimal marker walk: SOI..SOS for one baseline JPEG.

    Mirrors the reference's marker loop (decoder.zig:220-373) for the
    subset a baseline scan needs; anything else -> UnsupportedError.
    """
    if data[:2] != b"\xff\xd8":
        raise FormatError("jpeg: missing SOI")
    pos = 2
    quants = [None] * 4
    huffs = {}  # (tc, th) -> HuffTable
    sof = None
    dri = 0
    jfif = False
    adobe_transform = None
    while pos < len(data):
        if data[pos] != 0xFF:
            pos += 1  # liberal skip (decoder.zig:248-264)
            continue
        marker = data[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        pos += 2
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            continue
        if marker == 0xD9:
            break
        seg_len = (data[pos] << 8) | data[pos + 1]
        body = data[pos + 2 : pos + seg_len]
        if marker in (0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF):
            raise UnsupportedError("jpeg: only baseline/extended-sequential DCT")
        if marker == 0xC0 or marker == 0xC1:  # baseline / extended sequential
            prec, h, w, nc = body[0], (body[1] << 8) | body[2], (body[3] << 8) | body[4], body[5]
            if prec != 8:
                raise UnsupportedError("jpeg: only 8-bit precision")
            comps = []
            for i in range(nc):
                cid, hvb, tq = body[6 + 3 * i], body[7 + 3 * i], body[8 + 3 * i]
                comps.append((cid, hvb >> 4, hvb & 15, tq))
            if nc == 1:
                # grayscale ignores declared sampling factors
                # (decoder.zig:546-561 normalizes (h,v) to (1,1))
                cid, _, _, tq = comps[0]
                comps = [(cid, 1, 1, tq)]
            sof = (w, h, nc, tuple(comps))
        elif marker == 0xC2:
            raise UnsupportedError("jpeg: progressive not supported on-device")
        elif marker == 0xC4:  # DHT
            o = 0
            while o < len(body):
                tc, th = body[o] >> 4, body[o] & 15
                counts = list(body[o + 1 : o + 17])
                total = sum(counts)
                vals = bytes(body[o + 17 : o + 17 + total])
                t = HuffTable()
                t.build(counts, vals)
                huffs[(tc, th)] = t
                o += 17 + total
        elif marker == 0xDB:  # DQT
            o = 0
            while o < len(body):
                pq, tq = body[o] >> 4, body[o] & 15
                if pq == 0:
                    q = np.array(list(body[o + 1 : o + 65]), np.int32)
                    o += 65
                else:
                    raw = body[o + 1 : o + 129]
                    q = np.array(
                        [(raw[2 * i] << 8) | raw[2 * i + 1] for i in range(64)], np.int32
                    )
                    o += 129
                nat = np.zeros(64, np.int32)
                nat[UNZIG] = q  # store natural-order (decoder.zig:1564-1567)
                quants[tq] = nat
        elif marker == 0xDD:
            dri = (body[0] << 8) | body[1]
        elif marker == 0xE0:  # APP0 (JFIF)
            jfif = jfif or body[:5] == b"JFIF\x00"
        elif marker == 0xEE:  # APP14 (Adobe transform byte)
            if body[:6] == b"Adobe\x00" and len(body) >= 12:
                adobe_transform = body[11]
        elif marker == 0xDA:  # SOS
            ns = body[0]
            sel = []
            for i in range(ns):
                cs, tt = body[1 + 2 * i], body[2 + 2 * i]
                sel.append((cs, tt >> 4, tt & 15))
            scan_start = pos + seg_len
            if sof is None:
                raise FormatError("jpeg: SOS before SOF")
            w, h, nc, comps = sof
            if nc not in (1, 3, 4):
                raise UnsupportedError(
                    "jpeg: device decode covers 1/3/4-component frames"
                )
            # Color-space classification (decoder.zig:699-709, :795-809):
            # RGB = Adobe transform 0 or R/G/B component ids (non-JFIF);
            # 4-comp = YCCK (Adobe transform != 0) or raw CMYK (== 0);
            # no Adobe marker on 4-comp is the reference's error case.
            ids = tuple(c[0] for c in comps)
            is_rgb = (not jfif) and (
                adobe_transform == 0
                or (adobe_transform is None and ids == (0x52, 0x47, 0x42))
            )
            if nc == 1:
                color = "gray"
            elif nc == 3:
                color = "rgb" if is_rgb else "ycbcr"
            elif adobe_transform is None:
                raise UnsupportedError(
                    "jpeg: unknown color model: 4-component color model"
                )
            else:
                color = "cmyk" if adobe_transform == 0 else "ycck"
            if nc == 3:
                (h0, v0), (h1, v1), (h2, v2) = (
                    (c[1], c[2]) for c in comps
                )
                if (h1, v1) != (h2, v2) or min(h1, v1) < 1:
                    raise UnsupportedError(
                        "jpeg: chroma planes must share sampling factors"
                    )
                if h0 % h1 or v0 % v1 or ((h0 // h1) << 4 | (v0 // v1)) not in (
                    0x11, 0x12, 0x21, 0x22, 0x41, 0x42
                ):
                    raise UnsupportedError(
                        f"jpeg: unsupported sampling {h0}{v0}:{h1}{v1}:{h2}{v2}"
                    )
            if nc == 4:
                hvs = tuple((c[1], c[2]) for c in comps)
                if hvs not in (((1, 1),) * 4, ((2, 2), (1, 1), (1, 1), (2, 2))):
                    # the reference's 4-component matrix, decoder.zig:595-611
                    raise UnsupportedError(
                        "jpeg: unsupported 4-component sampling"
                    )
            return sof, quants, huffs, dri, tuple(sel), scan_start, color
        pos += seg_len
    raise FormatError("jpeg: no SOS")


def _destuff(data: bytes, scan_start: int):
    """Scan body -> (destuffed bytes, segment start offsets in destuffed space).

    FF00 de-stuffing per decoder.zig:712-749; RST markers delimit segments
    (byte-aligned restarts, decoder.zig:1432-1452).
    """
    d = np.frombuffer(data, np.uint8)[scan_start:]
    ff = np.flatnonzero(d[:-1] == 0xFF)
    nxt = d[ff + 1]
    stuffed = ff[nxt == 0x00]
    rst = ff[(nxt >= 0xD0) & (nxt <= 0xD7)]
    eoi = ff[nxt == 0xD9]
    end = int(eoi[0]) if len(eoi) else len(d)
    stuffed = stuffed[stuffed < end]
    rst = rst[rst < end]
    other = ff[(nxt != 0x00) & ((nxt < 0xD0) | (nxt > 0xD9))]
    if len(other) and int(other[0]) < end:
        # includes FF FF, which the reference rejects as MissingFF00
        # (decoder.zig:712-749) — fall back to the host decoder
        raise UnsupportedError("jpeg: unexpected marker inside scan data")
    # bytes to drop: each stuffed 00, and both bytes of each RST
    drop = np.concatenate([stuffed + 1, rst, rst + 1])
    drop.sort()
    keep = np.ones(end, bool)
    keep[drop[drop < end]] = False
    out = d[:end][keep]
    # segment starts (in destuffed coords): 0 and after each RST pair
    starts = np.concatenate([[0], rst + 2])
    dropped_before = np.searchsorted(drop, starts)
    return out, (starts - dropped_before).astype(np.int64)


def prep_batch(datas: list[bytes], cap_hint: int | None = None) -> ScanPlan:
    """Parse/destuff a batch; all images must share geometry AND tables.

    cap_hint: minimum stream-buffer capacity (bytes).  Batches whose
    pow2 bucket would be smaller adopt the hint, so a run over many
    distinct-content batches keeps ONE buffer layout (and ONE compiled
    program) even when totals straddle a pow2 boundary."""
    if not datas:
        raise ValueError("jpeg: empty batch")
    first = None
    streams, seg_pos_all, seg_nmcu_all = [], [], []
    for data in datas:
        sof, quants, huffs, dri, sel, scan_start, color = _parse_headers(data)
        w, h, nc, comps = sof
        if dri <= 0:
            raise UnsupportedError(
                "jpeg: device entropy decode needs restart markers (DRI)"
            )
        key = (sof, tuple(q.tobytes() if q is not None else None for q in quants),
               tuple(sorted((k, t.num_codes, tuple(t.vals), tuple(t.min_codes),
                             tuple(t.max_codes), tuple(t.vals_indices))
                            for k, t in huffs.items())), dri, tuple(sel), color)
        if first is None:
            first = (key, sof, quants, huffs, dri, sel, color)
        elif key != first[0]:
            raise UnsupportedError("jpeg: batch must share geometry and tables")
        stream, seg_starts = _destuff(data, scan_start)
        streams.append(stream)
        seg_pos_all.append(seg_starts)

    _, sof, quants, huffs, dri, sel, color = first
    w, h, nc, comps = sof
    h0, v0 = comps[0][1], comps[0][2]
    mxx = (w + 8 * h0 - 1) // (8 * h0)
    myy = (h + 8 * v0 - 1) // (8 * v0)
    n_mcu = mxx * myy
    comp_of_slot = []
    for c in range(nc):
        comp_of_slot += [c] * (comps[c][1] * comps[c][2])
    bpm = len(comp_of_slot)
    n_segs = (n_mcu + dri - 1) // dri
    for starts in seg_pos_all:
        if len(starts) != n_segs:
            raise UnsupportedError("jpeg: restart segment count mismatch")

    # One decode-table slot per distinct (class, table-id); comp c uses
    # cmp table index tid_dc[c] / tid_ac[c].  AC tables first: the
    # value pass's AC-only loop then touches a contiguous low word range
    # in the concatenated bit-plane space (see _make_sym_decoder).
    order = []
    for want_cls in (1, 0):
        for c, td, ta in sel:
            kk = (want_cls, ta if want_cls else td)
            if kk not in order:
                order.append(kk)
    tid_of = {kk: i for i, kk in enumerate(order)}
    cmp = CmpTables([huffs[kk] for kk in order])
    sel_by_comp = {i: (td, ta) for i, (_, td, ta) in enumerate(sel)}
    tid_dc = tuple(tid_of[(0, sel_by_comp[c][0])] for c in range(nc))
    tid_ac = tuple(tid_of[(1, sel_by_comp[c][1])] for c in range(nc))

    # Flat stream: segments of all images back to back (8-byte aligned
    # per image for cheap offset math), + 16 pad bytes for window reads.
    offs, total = [], 0
    for s in streams:
        offs.append(total)
        total += (len(s) + 7) // 8 * 8
    # bucket the stream size (power of two) so the jitted kernel re-traces
    # only per (geometry, tables, batch, size-bucket), not per byte count
    cap = 1 << max(12, (max(total + 16, cap_hint or 0) - 1).bit_length())
    flat = np.zeros(cap, np.uint8)
    for s, o in zip(streams, offs):
        flat[o : o + len(s)] = s
    seg_bit_pos = np.concatenate(
        [(o + p) * 8 for o, p in zip(offs, seg_pos_all)]
    ).astype(np.int64)
    max_seg_bits = 8 * max(
        int(np.max(np.diff(np.concatenate([starts, [len(stream_)]]))))
        for starts, stream_ in zip(seg_pos_all, streams)
    )
    # pow2 bucket so the step cap doesn't retrace per byte count
    max_seg_bits = 1 << max(10, (max_seg_bits - 1).bit_length())
    nm = np.full(n_segs, dri, np.int32)
    nm[-1] = n_mcu - dri * (n_segs - 1)
    seg_n_mcu = np.tile(nm, len(datas)).astype(np.int32)

    ratio = "gray"
    if nc >= 3:
        hr = comps[0][1] // comps[1][1]
        vr = comps[0][2] // comps[1][2]
        ratio = {0x11: "444", 0x12: "440", 0x21: "422",
                 0x22: "420", 0x41: "411", 0x42: "410"}[(hr << 4) | vr]
    # One-upload form: one device_put per batch, so the offsets ride in
    # the same buffer as the stream
    # (seg_n_mcu is a pure function of the geometry and is baked into
    # the compiled program instead of travelling at all).
    #
    # The tail also carries a length-sort permutation of the segment
    # lanes (perm: sorted->canonical, rank: canonical->sorted) for the
    # bins>1 pass-1 straggler mitigation (see build_decode_fn).  It is
    # DATA, so the compiled program is content-independent; bins=1
    # programs simply never read those bytes.
    seg_len_bytes = np.concatenate([
        np.diff(np.concatenate([starts, [len(stream_)]]))
        for starts, stream_ in zip(seg_pos_all, streams)
    ])
    sort_perm = np.argsort(seg_len_bytes, kind="stable").astype(np.int32)
    sort_rank = np.argsort(sort_perm, kind="stable").astype(np.int32)
    packed = np.concatenate(
        [flat, seg_bit_pos.astype("<i4").view(np.uint8),
         sort_perm.astype("<i4").view(np.uint8),
         sort_rank.astype("<i4").view(np.uint8)]
    )
    return ScanPlan(
        width=w, height=h, ncomp=nc,
        hv=tuple((c[1], c[2]) for c in comps), ratio=ratio,
        mxx=mxx, myy=myy, bpm=bpm, comp_of_slot=tuple(comp_of_slot),
        n_mcu=n_mcu, seg_mcus=dri, n_segs=n_segs,
        quants=[quants[c[3]] for c in comps],
        cmp=cmp, tid_dc=tid_dc, tid_ac=tid_ac,
        stream=flat, seg_bit_pos=seg_bit_pos, seg_n_mcu=seg_n_mcu,
        max_seg_bits=max_seg_bits, batch=len(datas),
        cache_key=(first[0], len(datas), max_seg_bits),
        packed=packed, color=color,
    )


# ---------------------------------------------------------------- kernel


def _select_by_index(jnp, idx, values):
    """Per-lane select from a tuple of trace-time constant ints."""
    out = jnp.full(idx.shape, values[0], jnp.int32)
    for j in range(1, len(values)):
        out = jnp.where(idx == j, jnp.int32(values[j]), out)
    return out


def _rshift(jnp, x, n):
    """x >> n for per-lane n in [0, 32] (XLA shift-by-32 is undefined)."""
    n = jnp.clip(n, 0, 32)
    big = n >= 32
    return jnp.where(big, jnp.uint32(0), x >> jnp.where(big, jnp.uint32(0), n.astype(jnp.uint32)))


def _bits_at(jnp, w, p, n):
    """Extract bits [p, p+n) (MSB-first) from a 32*W-bit window w = (w0..wK).

    p, n per-lane int32; requires p <= 32*(W-1) and p+n <= 32*W and
    n <= 25.  Returns uint32 with the n bits right-aligned.
    """
    W = len(w)
    sh = (p & 31).astype(jnp.uint32)
    pi = p >> 5  # word index 0..W-1
    a = w[W - 1]
    b = jnp.zeros_like(w[0])
    for i in range(W - 2, -1, -1):
        a = jnp.where(pi == i, w[i], a)
        b = jnp.where(pi == i, w[i + 1], b)
    word = jnp.where(sh > 0, (a << sh) | _rshift(jnp, b, 32 - (p & 31)), a)
    return _rshift(jnp, word, 32 - n)


def _make_sym_decoder(jnp, cmp: CmpTables):
    """Per-symbol canonical decode with zero gathers (see CmpTables).

    Returns decode(look16 int32 [L], mt: list of ntab table masks) ->
    (code_len [L], symbol [L], bad [L]).  A mask entry may be a bool [L]
    array, the literal ``True`` (that table covers every lane — skips
    the per-lane selects entirely), or ``None`` (table statically absent
    from this call site — its compare chain is not emitted and its words
    drop out of the bit-plane select).  All table data is embedded as
    scalar constants; the whole thing is branch-free elementwise math
    that XLA fuses into the surrounding loop body.
    """
    lims, aoff, planes = cmp.lims, cmp.aoff, cmp.planes

    def decode(look, mt):
        i32 = jnp.int32
        ln = jnp.zeros(look.shape, i32)
        a = jnp.zeros(look.shape, i32)
        bad = jnp.zeros(look.shape, bool)
        tset = [t for t in range(cmp.ntab) if mt[t] is not None]
        for t in tset:
            lnt = jnp.full(look.shape, 1, i32)
            at = jnp.full(look.shape, aoff[t][0], i32)
            for i in range(15):
                ge = look >= i32(lims[t][i])
                lnt = lnt + ge.astype(i32)
                d = aoff[t][i + 1] - aoff[t][i]
                if d:
                    at = at + jnp.where(ge, i32(d), 0)
            if mt[t] is True:
                ln, a = lnt, at
                bad = look >= i32(lims[t][15])
            else:
                ln = jnp.where(mt[t], lnt, ln)
                a = jnp.where(mt[t], at, a)
                bad = bad | (mt[t] & (look >= i32(lims[t][15])))
        sh = jnp.clip(16 - ln, 0, 16).astype(jnp.uint32)
        vidx = a + (look.astype(jnp.uint32) >> sh).astype(i32)
        w = vidx >> 5
        shv = (vidx & 31).astype(jnp.uint32)
        sym = jnp.zeros(look.shape, i32)
        # only the words a valid vidx of the active tables can hit
        wlo = min(cmp.bases[t] >> 5 for t in tset)
        whi = max((cmp.bases[t] + max(cmp.counts[t], 1) - 1) >> 5 for t in tset)
        for b in range(8):
            word = jnp.zeros(look.shape, jnp.uint32)
            for ww in range(wlo, whi + 1):
                pw = planes[b][ww]
                if pw:
                    word = word | jnp.where(
                        w == ww, jnp.uint32(pw), jnp.uint32(0)
                    )
            sym = sym | (((word >> shv) & jnp.uint32(1)) << b).astype(i32)
        return ln, sym, bad

    return decode



def _make_window_fetch(win):
    """Per-step window fetch: byte index [L] -> tuple of W uint32 [L].

    ``win`` is either a stacked [N, W] array (ONE row gather) or a tuple
    of W [N] word arrays (W independent full-lane [L] gathers).  Which is
    faster is backend-dependent (tools/ab_bench.py).
    """
    if isinstance(win, tuple):
        return lambda byte: tuple(wd[byte] for wd in win)
    W = win.shape[-1]
    return lambda byte: tuple(win[byte][:, i] for i in range(W))


def _win_words(win):
    return len(win) if isinstance(win, tuple) else win.shape[-1]


def _table_masks(jnp, tidv, tset, ntab):
    """Static mask list for _make_sym_decoder: ``None`` for tables that
    cannot occur, the literal ``True`` when a single table covers every
    lane, per-lane compares otherwise."""
    tset = sorted(set(tset))
    if len(tset) == 1:
        return [True if t == tset[0] else None for t in range(ntab)]
    return [(tidv == t) if t in tset else None for t in range(ntab)]


def _merge_masks(jnp, first, mt_a, mt_b, ntab):
    """Mask list selecting mt_a when ``first`` (traced scalar bool) else
    mt_b, preserving the None (statically absent) encoding."""
    out = []
    for t in range(ntab):
        a, b = mt_a[t], mt_b[t]
        if a is None and b is None:
            out.append(None)
            continue
        av = None if a is None else (first if a is True else first & a)
        bv = None if b is None else (~first if b is True else ~first & b)
        out.append(av if bv is None else bv if av is None else av | bv)
    return out


def _value_pass(jax, jnp, *, win, cmp, n, starts, done0, tid_dc2, tid_ac2,
                k_syms, dc_set=None, ac_set=None, split16=False):
    """Shared value pass: one lane per 8x8 block at a known bit offset.

    Decodes DC diff + AC run-length coefficients into NATURAL-order
    coefficient rows (one-hot emissions compared against the
    zigzag-of-natural permutation constant, so the inverse-zigzag
    reorder of decoder.zig:73-82 costs nothing; RECEIVE/EXTEND per
    T.81 F.2.2.1, decoder.zig:1115-1134).

    Every block starts with exactly one DC symbol, and every lane
    starts at its block's DC: the DC happens at symbol slot 0 of the
    FIRST while-loop step for all lanes simultaneously.  The body
    therefore special-cases only (step 0, slot 0) — gated by one traced
    ``steps == 0`` scalar, sharing the step's window fetch — and every
    other symbol slot is pure AC: no per-lane phase state, no DC/AC
    table selects, and the symbol bit-plane select touches only the AC
    word range.

    The coefficient store is carried TRANSPOSED, [64, L2], so the huge
    lane axis is minor and every emission op writes full-lane rows.

    Returns (bit_pos, curT, k, done, err, steps) — bit_pos lands on
    each block's end boundary, which callers check against the index
    pass for exact verification; curT is [64, L2].
    """
    L2 = starts.shape[0]
    W = _win_words(win)
    off_lim = 32 * W - 48  # look16 + extend both stay inside the window
    decode_sym = _make_sym_decoder(jnp, cmp)
    dc_set = set(dc_set if dc_set is not None else range(cmp.ntab))
    ac_set = set(ac_set if ac_set is not None else range(cmp.ntab))
    mt_dc = _table_masks(jnp, tid_dc2, dc_set, cmp.ntab)
    mt_ac = _table_masks(jnp, tid_ac2, ac_set, cmp.ntab)

    fetch = _make_window_fetch(win)

    def receive_extend(w, pos, size):
        """RECEIVE+EXTEND, branch-free (decoder.zig:1115-1134)."""
        raw = _bits_at(jnp, w, pos, jnp.clip(size, 0, 16)).astype(jnp.int32)
        raw = jnp.where(size > 0, raw, 0)
        sz = jnp.clip(size, 0, 16)
        bias = jnp.where(size > 0, (jnp.int32(1) << sz) - 1, 0)
        top_clear = raw < (jnp.int32(1) << jnp.clip(size - 1, 0, 15))
        return jnp.where(size > 0, jnp.where(top_clear, raw - bias, raw), 0)

    inv = np.zeros(64, np.int64)
    inv[UNZIG] = np.arange(64)
    invT = jnp.asarray(inv)[:, None]  # zigzag index of natural position p

    def body2(st):
        if split16:
            (bit_pos, curT, dcv, k, done, err, steps) = st
        else:
            (bit_pos, curT, k, done, err, steps) = st
            dcv = None
        first = steps == 0
        byte = jnp.clip(bit_pos >> 3, 0, n - 1)
        w = fetch(byte)
        off0 = (bit_pos & 7).astype(jnp.int32)
        off = off0
        emits = []  # per-symbol [L] (value, position) pairs, emitted below

        for si in range(k_syms):
            active = (~done) & (off <= off_lim)
            look16 = _bits_at(jnp, w, off, jnp.int32(16)).astype(jnp.int32)
            if si == 0:
                # slot 0 of step 0 is the DC symbol on EVERY lane
                mt = _merge_masks(jnp, first, mt_dc, mt_ac, cmp.ntab)
                ln_sel, sym, bad = decode_sym(look16, mt)
                is_dc = first
                r = jnp.where(is_dc, 0, sym >> 4)
                size = jnp.where(is_dc, sym, sym & 15)
            else:
                ln_sel, sym, bad = decode_sym(look16, mt_ac)
                is_dc = False
                r = sym >> 4
                size = sym & 15
            bad = active & bad

            ext = receive_extend(w, off + ln_sel, size)
            consume = ln_sel + size
            emit_k = jnp.clip(k + r, 0, 63)
            ac_coef = size > 0
            new_k = jnp.where(ac_coef, emit_k + 1, k)
            eob = (size == 0) & (r != 15)
            zrl = (size == 0) & (r == 15)
            new_k = jnp.where(zrl, k + 16, new_k)
            blk_done = eob | (new_k > 63)
            if si == 0:
                # DC: emit the raw diff at position 0, k -> 1, never done
                emit_k = jnp.where(is_dc, 0, emit_k)
                ac_coef = ac_coef | is_dc
                new_k = jnp.where(is_dc, 1, new_k)
                blk_done = blk_done & ~is_dc

            app = active & ~bad
            # collect [L]-wide scalars only; the [64, L] one-hot work
            # happens ONCE per step below (a per-symbol one-hot emission
            # costs a separate wide kernel each — ~50 us per symbol slot
            # regardless of lane count, and dominated the whole decode)
            if split16 and si == 0:
                # split16: the DC diff (up to 16 extend bits, may exceed
                # int16) rides its own int32 row; the int16 store carries
                # AC only (15 extend bits max -> fits exactly)
                dcv = jnp.where(first & app, ext, dcv)
                emits.append((
                    jnp.where(app & ac_coef & ~is_dc, ext, 0).astype(
                        jnp.int16
                    ),
                    emit_k,
                ))
            elif split16:
                emits.append(
                    (jnp.where(app & ac_coef, ext, 0).astype(jnp.int16),
                     emit_k)
                )
            else:
                emits.append((jnp.where(app & ac_coef, ext, 0), emit_k))
            k = jnp.where(app, new_k, k)
            off = jnp.where(app, off + consume, off)
            err = err | bad
            done = done | (app & blk_done) | bad
        # emission position k is a ZIGZAG index; comparing against the
        # zigzag-index-of-natural-position constant writes natural order
        # directly (same op count as comparing against arange)
        zero = jnp.int16(0) if split16 else 0
        curT = curT + sum(
            jnp.where(ek[None, :] == invT, ev[None, :], zero)
            for ev, ek in emits
        )  # one read-modify-write of curT per step
        bit_pos = bit_pos - off0 + off
        if split16:
            return (bit_pos, curT, dcv, k, done, err, steps + 1)
        return (bit_pos, curT, k, done, err, steps + 1)

    di = 1 if split16 else 0

    def cond2(st):
        # a block holds <= 64 symbols and every step decodes >= 1
        n_done = jnp.sum(st[3 + di].astype(jnp.int32))
        return (n_done < st[3 + di].shape[0]) & (st[5 + di] < 81)

    init = [
        starts,
        jnp.zeros((64, L2), jnp.int16 if split16 else jnp.int32),
        jnp.zeros(L2, jnp.int32),
        done0,
        jnp.zeros(L2, bool),
        jnp.int32(0),
    ]
    if split16:
        init.insert(2, jnp.zeros(L2, jnp.int32))  # dcv
    return jax.lax.while_loop(cond2, body2, tuple(init))


def _restore_dc_and_reorder(jnp, cur, *, groups, n_mcu_grp, bpm, hv, ncomp,
                            dtype=None):
    """DC-predictor restore over natural-order rows.

    cur: [groups * n_mcu_grp * bpm, 64] NATURAL-order rows (the value
    pass emits through the zigzag permutation) whose position 0 is the
    raw DC DIFF.  A group is one predictor chain (a restart segment, or
    a whole restart-free image).  Per component, adds the EXCLUSIVE
    prefix sum of preceding diffs at position 0 as a broadcast add.
    Returns
    [groups, n_mcu_grp * bpm, 64] coefficients
    (decoder.zig:1366-1376, :73-82), int16 by default (the transfer
    format); fused consumers pass dtype=int32 to skip the narrowing
    round trip.
    """
    coeff = cur.reshape(groups, n_mcu_grp, bpm, 64)
    dc = coeff[..., 0]  # [G, M, bpm] raw diffs
    corr = _dc_prefix(jnp, dc, groups=groups, n_mcu_grp=n_mcu_grp,
                      hv=hv, ncomp=ncomp)
    one0 = jnp.asarray((np.arange(64) == 0).astype(np.int32))
    coeff = coeff + corr[..., None] * one0
    out = coeff.reshape(groups, n_mcu_grp * bpm, 64)
    return out.astype(dtype if dtype is not None else jnp.int16)


def _dc_prefix(jnp, dc, *, groups, n_mcu_grp, hv, ncomp):
    """Exclusive per-group per-component prefix sum of DC diffs.

    dc: [G, M, bpm] raw diffs -> [G, M, bpm] predictor bases
    (decoder.zig:1366-1376; a group is one predictor chain)."""
    parts = []
    s0 = 0
    for c in range(ncomp):
        nbc = hv[c][0] * hv[c][1]
        d = dc[:, :, s0 : s0 + nbc].reshape(groups, -1)
        pre = (jnp.cumsum(d, axis=1) - d).reshape(groups, n_mcu_grp, nbc)
        parts.append(pre)
        s0 += nbc
    return jnp.concatenate(parts, axis=2)  # [G, M, bpm]


def _restore_dc_T(jnp, curT, *, groups, n_mcu_grp, bpm, hv, ncomp):
    """DC-predictor restore on the TRANSPOSED SLOT-MAJOR store
    curT [64, bpm*G*M]: adds the exclusive prefix sum of DC diffs to
    row 0 as one broadcast add (lane axis stays minor throughout).

    A component's predictor chain visits blocks in (MCU, slot) order
    (decoder.zig:1366-1376), so with slots major the exclusive prefix
    splits into a per-MCU cumsum of MCU totals plus an intra-MCU
    exclusive sum over the component's slots — all ops minor on the
    huge G*M axis."""
    dc = curT[0].reshape(bpm, groups, n_mcu_grp)
    parts = []
    s0 = 0
    for c in range(ncomp):
        nbc = hv[c][0] * hv[c][1]
        d = dc[s0 : s0 + nbc]  # [nbc, G, M]
        tot = d.sum(axis=0)  # [G, M] per-MCU diff total
        base = jnp.cumsum(tot, axis=1) - tot  # exclusive over MCUs
        partial = jnp.cumsum(d, axis=0) - d  # exclusive over slots
        parts.append(base[None] + partial)
        s0 += nbc
    corr = jnp.concatenate(parts, axis=0).reshape(-1)
    one0 = jnp.asarray((np.arange(64) == 0).astype(np.int32))[:, None]
    return curT + corr[None, :] * one0


def _restore_dc_T_split(jnp, dcv, *, groups, n_mcu_grp, bpm, hv, ncomp):
    """DC-predictor restore for the split16 store: only the dedicated
    int32 DC row is touched (the [64, L2] int16 AC store is not re-read),
    same chain semantics as _restore_dc_T."""
    dc = dcv.reshape(bpm, groups, n_mcu_grp)
    parts = []
    s0 = 0
    for c in range(ncomp):
        nbc = hv[c][0] * hv[c][1]
        d = dc[s0 : s0 + nbc]
        tot = d.sum(axis=0)
        base = jnp.cumsum(tot, axis=1) - tot
        partial = jnp.cumsum(d, axis=0) - d
        parts.append(base[None] + partial)
        s0 += nbc
    return dcv + jnp.concatenate(parts, axis=0).reshape(-1)


def build_decode_fn(
    plan: ScanPlan, *, k_syms: int | None = None, max_steps: int | None = None,
    win_words: int | None = None, k1_syms: int | None = None,
    win1_words: int | None = None, packed: bool = False,
    coeff_dtype=None, _stage: int = 2, _raw: bool = False,
    _soa_out: bool = False, split_win: bool | None = None,
    mesh=None, i16: bool | None = None, p1_i16: bool | None = None,
    bins: int | None = None, ends_in: bool = False, _stats: bool = False,
):
    """Returns a jitted fn: (stream_u8, seg_bit_pos, seg_n_mcu) ->
    (coeffs [L1, seg_mcus*bpm, 64] int16 natural-order, ok flag).

    Two-pass, scatter-free decode (the index-pass/value-pass split used by
    parallel JPEG decoders, mapped onto SIMD lanes):

    * **Pass 1 (index pass)** — one lane per restart segment.  Decodes only
      symbol lengths + run/size (no extend-bit reads, no value emission)
      to find where every 8x8 block's entropy data ends, and
      accumulates each completed block's end bit-position into [L1, nblk]
      with a one-hot over nblk: O(total blocks) vector work per step, no
      scatter anywhere.
    * **Pass 2 (value pass)** — one lane per BLOCK at the now-known bit
      offsets.  Every lane decodes exactly its own block's coefficients
      into its own [64] row (one-hot over 64 per symbol), so the output is
      written positionally — again no scatter, and the work per lane is
      uniform (<= 64 symbols), which keeps tens of thousands of lanes busy
      in lock-step.  DC symbols emit the raw DIFF (T.81 F.2.1.3.1); the
      per-segment predictor chain (decoder.zig:1366-1376) is restored
      afterwards by a segmented cumsum over the MCU axis per component.

    Pass 2 re-derives every block end independently; `ok` requires the two
    passes to agree bit-for-bit, which catches any corrupt stream that
    still happened to parse.

    Everything shape- or table-dependent is closed over as trace-time
    constants (including the gather-free decode tables, see CmpTables),
    so one compilation covers a whole (geometry, tables) bucket and no
    tables travel per call.
    """
    import jax
    import jax.numpy as jnp

    bpm = plan.bpm
    nblk = plan.seg_mcus * bpm
    n_mcu_seg = plan.seg_mcus
    comp_of_slot = plan.comp_of_slot
    tid_of_slot_dc = tuple(plan.tid_dc[c] for c in comp_of_slot)
    tid_of_slot_ac = tuple(plan.tid_ac[c] for c in comp_of_slot)
    cmp = plan.cmp
    k_syms = k_syms if k_syms is not None else _DEF_K
    W = win_words if win_words is not None else _DEF_W
    W1 = win1_words if win1_words is not None else _DEF_W1
    off_lim = 32 * W - 48  # look16 + extend both stay inside the window
    off_lim1 = 32 * W1 - 48
    k1 = k1_syms if k1_syms is not None else _DEF_K1
    if split_win is None:
        split_win = _DEF_SPLIT_WIN
    if i16 is None:
        i16 = _DEF_I16
    i16 = bool(i16) and _soa_out and _stage == 2
    # pass-1 records block ends RELATIVE to the segment start in int16
    # (halves the [nblk, L1] one-hot emission traffic); exact whenever
    # the longest segment + window overhang fits 15 bits — auto-gated.
    if p1_i16 is None:
        p1_i16 = _DEF_P1I16
    p1_i16 = bool(p1_i16) and (plan.max_seg_bits + 512 < 32768)
    bins = _DEF_BINS if bins is None else int(bins)
    if bins > 1 and (not packed or mesh is not None):
        raise ValueError(
            "jpeg: bins > 1 needs the packed single-device form (the "
            "sort permutation rides in the packed buffer)"
        )
    bins = max(1, min(bins, plan.batch * plan.n_segs))
    if ends_in and (not packed or mesh is not None or bins > 1):
        raise ValueError(
            "jpeg: ends_in (host index pass) needs the plain packed form"
        )
    if max_steps is None:
        # every pass-1 step consumes >= min(k1 symbols of >= 2 bits,
        # the window capacity) or finishes the lane, so the longest
        # segment bounds the loop
        per_step = max(2, min(2 * k1, off_lim1 - 38))
        max_steps = plan.max_seg_bits // per_step + 64

    def decode(stream, seg_bit_pos, seg_n_mcu, sort_perm=None,
               sort_rank=None, host_ends=None):
        L1 = seg_bit_pos.shape[0]
        L2 = L1 * nblk
        u32 = jnp.uint32
        # 4*W-byte windows at every byte offset: [N, W] uint32 big-endian.
        # A wide window amortizes the per-step gather + state costs over
        # more symbols (row-gather cost grows only mildly with width);
        # pass 1 wants the widest window (its step count is bounded by
        # window bits, and each while-loop step pays a fixed loop
        # overhead), pass 2 a narrow one (its blocks finish in a few steps).
        s = stream.astype(u32)
        wmax = max(W, W1)
        n = stream.shape[0] - 4 * wmax
        b = [s[i : n + i] for i in range(4 * wmax)]
        words = [
            (b[4 * j] << 24) | (b[4 * j + 1] << 16) | (b[4 * j + 2] << 8) | b[4 * j + 3]
            for j in range(wmax)
        ]
        if split_win:
            win = tuple(words[:W])
            win1 = win if W1 == W else tuple(words[:W1])
        else:
            win = jnp.stack(words[:W], axis=-1)
            win1 = win if W1 == W else jnp.stack(words[:W1], axis=-1)
        fetch1 = _make_window_fetch(win1)
        decode_sym = _make_sym_decoder(jnp, cmp)

        # ---------------- pass 1: block end bit-positions per segment
        # (offs carried TRANSPOSED, [nblk, L1]: nblk is small — 24 at
        # dri=4 — so lane-minor layout keeps the one-hot emission ops
        # from wasting 128-nblk of every vector register row)
        seg_start32 = seg_bit_pos.astype(jnp.int32)
        e_dtype = jnp.int16 if p1_i16 else jnp.int32
        e_zero = jnp.int16(0) if p1_i16 else 0

        def run_pass1(pos0, nm):
            """Index pass over one lane group: pos0/nm int32 [Lb]."""
            Lb = pos0.shape[0]

            def body1(st):
                (bit_pos, offsT, slot, mcu_cnt, k, phase, done, err, steps) = st
                byte = jnp.clip(bit_pos >> 3, 0, n - 1)
                w = fetch1(byte)
                off0 = (bit_pos & 7).astype(jnp.int32)
                off = off0
                base = (byte << 3).astype(jnp.int32)  # window start, abs bits
                emits = []  # per-symbol [Lb] (block index, end) pairs

                for _ in range(k1):
                    active = (~done) & (off <= off_lim1)
                    look16 = _bits_at(jnp, w, off, jnp.int32(16)).astype(jnp.int32)
                    is_dc = phase == 0
                    tid = jnp.where(
                        is_dc,
                        _select_by_index(jnp, slot, tid_of_slot_dc),
                        _select_by_index(jnp, slot, tid_of_slot_ac),
                    )
                    mt = [tid == t for t in range(cmp.ntab)]
                    ln_sel, sym, bad = decode_sym(look16, mt)
                    bad = active & bad
                    r = jnp.where(is_dc, 0, sym >> 4)
                    size = jnp.where(is_dc, sym, sym & 15)
                    consume = ln_sel + size  # extend bits skipped, not read

                    new_k = jnp.where(is_dc, 1, k)
                    ac_coef = (~is_dc) & (size > 0)
                    new_k = jnp.where(ac_coef, jnp.clip(k + r, 0, 63) + 1, new_k)
                    eob = (~is_dc) & (size == 0) & (r != 15)
                    zrl = (~is_dc) & (size == 0) & (r == 15)
                    new_k = jnp.where(zrl, k + 16, new_k)
                    blk_done = (eob | (new_k > 63)) & ~is_dc

                    app = active & ~bad
                    adv_blk = app & blk_done
                    # record block end; [Lb]-wide scalars only here — the
                    # [Lb, nblk] one-hot materializes ONCE per step below
                    # (a per-symbol one-hot costs a separate wide kernel)
                    blk_idx = jnp.clip(mcu_cnt * bpm + slot, 0, nblk - 1)
                    end_abs = base + off + consume
                    ev = jnp.where(adv_blk, end_abs - (pos0 if p1_i16 else 0), 0)
                    emits.append((blk_idx, ev.astype(e_dtype) if p1_i16 else ev))
                    slot = jnp.where(adv_blk, slot + 1, slot)
                    wrap = adv_blk & (slot >= bpm)
                    slot = jnp.where(wrap, 0, slot)
                    mcu_cnt = jnp.where(wrap, mcu_cnt + 1, mcu_cnt)
                    k = jnp.where(adv_blk, 0, jnp.where(app, new_k, k))
                    phase = jnp.where(adv_blk, 0, jnp.where(app & is_dc, 1, phase))
                    off = jnp.where(app, off + consume, off)
                    err = err | bad
                    done = done | (mcu_cnt >= nm) | bad
                arb = jnp.arange(nblk)[:, None]
                offsT = offsT + sum(
                    jnp.where(bi[None, :] == arb, ev[None, :], e_zero)
                    for bi, ev in emits
                )  # one read-modify-write of offsT per step
                bit_pos = bit_pos - off0 + off
                return (bit_pos, offsT, slot, mcu_cnt, k, phase, done, err,
                        steps + 1)

            def cond1(st):
                # sum-based termination test (bool all-reduce miscompiles on
                # some backend shapes; an integer reduction is robust)
                n_done = jnp.sum(st[6].astype(jnp.int32))
                return (n_done < st[6].shape[0]) & (st[8] < max_steps)

            return jax.lax.while_loop(
                cond1,
                body1,
                (
                    pos0,
                    jnp.zeros((nblk, Lb), e_dtype),
                    jnp.zeros(Lb, jnp.int32),
                    jnp.zeros(Lb, jnp.int32),
                    jnp.zeros(Lb, jnp.int32),
                    jnp.zeros(Lb, jnp.int32),
                    jnp.zeros(Lb, bool),
                    jnp.zeros(Lb, bool),
                    jnp.int32(0),
                ),
            )

        if ends_in:
            # Host C++ index pass already produced every block's end bit
            # offset (zpix_baseline_index_scan): skip pass 1 entirely.
            # Pass 2 re-derives each end independently and the `agree`
            # check below still verifies the host pass bit-for-bit.
            ends = host_ends.reshape(L1, nblk)
            ok1 = jnp.asarray(True)
            p1_steps = jnp.int32(0)
        elif bins > 1:
            # Straggler mitigation: lanes arrive length-sorted via the
            # data-level permutation (prep_batch); each contiguous group
            # runs its own while loop, exiting at its OWN longest
            # segment.  Outputs are un-permuted with one row gather.
            srt_pos = seg_start32[sort_perm]
            nm_srt = seg_n_mcu[sort_perm]
            parts, dones, errs = [], [], []
            p1_steps = jnp.int32(0)
            for b_ in range(bins):
                lo, hi = b_ * L1 // bins, (b_ + 1) * L1 // bins
                st1 = run_pass1(srt_pos[lo:hi], nm_srt[lo:hi])
                parts.append(st1[1])
                dones.append(st1[6])
                errs.append(st1[7])
                p1_steps = p1_steps + st1[8]
            endsT = jnp.concatenate(parts, axis=1)  # [nblk, L1] sorted
            ends_s = endsT.T.astype(jnp.int32)
            if p1_i16:
                ends_s = jnp.where(endsT.T != 0, ends_s + srt_pos[:, None], 0)
            ends = ends_s[sort_rank]  # [L1, nblk] canonical order
            ok1 = (jnp.all(jnp.concatenate(dones))
                   & ~jnp.any(jnp.concatenate(errs)))
        else:
            st1 = run_pass1(seg_start32, seg_n_mcu.astype(jnp.int32))
            ends = st1[1].T.astype(jnp.int32)  # [L1, nblk]
            if p1_i16:
                # relative int16 -> absolute; padding blocks (never emitted)
                # map back to the segment start, same as the int32 form's 0
                # ... except int32 stored absolute; keep their starts exact:
                ends = jnp.where(st1[1].T != 0, ends + seg_start32[:, None], 0)
            ok1 = jnp.all(st1[6]) & ~jnp.any(st1[7])
            p1_steps = st1[8]
        if _stage == 1:  # debug: index pass only
            return ends, ok1

        # ---------------- pass 2: one lane per block, SLOT-MAJOR lanes
        # Lane order [bpm, L1, seg_mcus]: the component axis is then
        # MAJOR in the coefficient store, so the SoA back-end slices
        # components as contiguous views and every per-position row
        # keeps the huge (L1*seg_mcus) axis minor.  The permutes here
        # touch only [L2]-sized int32/bool arrays (cheap); the [64, L2]
        # store itself is born in the right order.
        starts_blk = jnp.concatenate(
            [seg_bit_pos.astype(jnp.int32)[:, None], ends[:, :-1]], axis=1
        )
        to_sm = lambda a: jnp.transpose(  # noqa: E731
            a.reshape(L1, n_mcu_seg, bpm), (2, 0, 1)
        ).reshape(-1)
        starts = to_sm(starts_blk)
        valid = jnp.broadcast_to(
            jnp.arange(n_mcu_seg)[None, None, :] < seg_n_mcu[None, :, None],
            (bpm, L1, n_mcu_seg),
        ).reshape(-1)
        slot2 = (jnp.arange(L2) // (L1 * n_mcu_seg)).astype(jnp.int32)
        tid_dc2 = _select_by_index(jnp, slot2, tid_of_slot_dc)
        tid_ac2 = _select_by_index(jnp, slot2, tid_of_slot_ac)

        st2 = _value_pass(
            jax, jnp, win=win, cmp=cmp, n=n, starts=starts,
            done0=~valid, tid_dc2=tid_dc2, tid_ac2=tid_ac2, k_syms=k_syms,
            dc_set=set(tid_of_slot_dc), ac_set=set(tid_of_slot_ac),
            split16=i16,
        )
        di = 1 if i16 else 0
        curT = st2[1]  # [64, L2] slot-major lanes

        def to_legacy(cT):
            # [64, bpm, L1, M] -> [L1, M, bpm, 64] -> [L2, 64]
            return jnp.transpose(
                cT.reshape(64, bpm, L1, n_mcu_seg), (2, 3, 1, 0)
            ).reshape(L2, 64)

        if _stage == 15:  # debug: value pass, raw
            return to_legacy(curT).astype(jnp.int16), jnp.all(st2[3])
        # integrity: pass 2 must land exactly on pass 1's block ends
        agree = (st2[0] == to_sm(ends)) | ~valid
        ok = (
            ok1
            & jnp.all(st2[3 + di])
            & ~jnp.any(st2[4 + di] & valid)
            & jnp.all(agree)
        )
        if _stage == 17:  # debug: + integrity check
            return to_legacy(curT).astype(jnp.int16), ok

        # while-loop trip counts for the roofline accounting
        # (utils/roofline.py): the loops' HBM traffic = carry x trips.
        # With bins > 1 this is the SUM across bins (each bin's step
        # touches only L1/bins lanes, so the model overestimates).
        stats = (p1_steps, st2[5 + di]) if _stats else None

        if _soa_out:
            if i16:
                # (int32 DC row with predictors restored, int16 AC store)
                dcrow = _restore_dc_T_split(
                    jnp, st2[2], groups=L1, n_mcu_grp=n_mcu_seg, bpm=bpm,
                    hv=plan.hv, ncomp=plan.ncomp,
                )
                out = (dcrow, curT)
            else:
                # lane-minor store straight into the SoA back-end: DC fix
                # is a broadcast add; no [L2, 64]-major relayout anywhere
                out = _restore_dc_T(
                    jnp, curT, groups=L1, n_mcu_grp=n_mcu_seg, bpm=bpm,
                    hv=plan.hv, ncomp=plan.ncomp,
                )
            return (out, ok, stats) if _stats else (out, ok)

        coeffs = _restore_dc_and_reorder(
            jnp, to_legacy(curT), groups=L1, n_mcu_grp=n_mcu_seg, bpm=bpm,
            hv=plan.hv, ncomp=plan.ncomp, dtype=coeff_dtype,
        )
        return (coeffs, ok, stats) if _stats else (coeffs, ok)

    if packed:
        # Single-buffer form: [stream bytes | seg_bit_pos LE int32];
        # seg_n_mcu is a geometry constant baked into the program.
        cap = int(plan.stream.shape[0])
        L = int(plan.batch * plan.n_segs)
        nm_const = np.full(plan.n_segs, plan.seg_mcus, np.int32)
        nm_const[-1] = plan.n_mcu - plan.seg_mcus * (plan.n_segs - 1)
        nm_const = np.tile(nm_const, plan.batch)

        if mesh is not None:
            # Shard-compatible packed upload: one [ndev, cap + 4*Lc] array
            # (row d = full stream ++ device d's lane offsets) sharded on
            # axis 0; each shard entropy-decodes its own lanes via
            # shard_map — the transfer-efficient form composes with the
            # mesh (restart segments need no collectives).
            from jax.sharding import PartitionSpec as P

            from jax import shard_map as _shard_map

            if _soa_out or _stage != 2:
                raise ValueError(
                    "jpeg: packed+mesh decode emits legacy [L, nblk, 64] "
                    "coefficients (lane axis leading, for the shard spec)"
                )
            ndev = mesh.shape["batch"]
            if L % ndev:
                raise ValueError(
                    f"jpeg: mesh batch axis ({ndev}) must divide the lane "
                    f"count ({L}); pad the batch"
                )
            Lc = L // ndev

            def decode_shard(buf):
                row = buf[0]
                stream = row[:cap]
                pb = row[cap : cap + 4 * Lc].reshape(Lc, 4).astype(jnp.int32)
                seg_bit_pos = (
                    pb[:, 0] | (pb[:, 1] << 8) | (pb[:, 2] << 16)
                    | (pb[:, 3] << 24)
                )
                d = jax.lax.axis_index("batch")
                nm = jax.lax.dynamic_slice(
                    jnp.asarray(nm_const), (d * Lc,), (Lc,)
                )
                coeffs, ok = decode(stream, seg_bit_pos, nm)
                return coeffs, ok[None]

            sm = _shard_map(
                decode_shard, mesh=mesh,
                in_specs=P("batch", None),
                out_specs=(P("batch"), P("batch")),
                check_vma=False,  # per-lane local loop carries start as
                # unvarying constants; there is no cross-device
                # communication for the checker to validate
            )

            def decode_packed_mesh(buf):
                coeffs, oks = sm(buf)
                return coeffs, jnp.all(oks)

            if _raw:
                return decode_packed_mesh
            return jax.jit(decode_packed_mesh)

        def decode_packed(buf):
            import jax.numpy as jnp

            def le32(off):
                pb = buf[off : off + 4 * L].reshape(L, 4).astype(jnp.int32)
                return (pb[:, 0] | (pb[:, 1] << 8) | (pb[:, 2] << 16)
                        | (pb[:, 3] << 24))

            stream = buf[:cap]
            seg_bit_pos = le32(cap)
            perm = rank = hends = None
            if bins > 1:  # length-sort permutation (see prep_batch tail)
                perm, rank = le32(cap + 4 * L), le32(cap + 8 * L)
            if ends_in:  # host-index packed form: [stream | pos | ends]
                nblk_ = plan.seg_mcus * plan.bpm
                pb = buf[cap + 4 * L : cap + 4 * L + 4 * L * nblk_]
                pb = pb.reshape(L * nblk_, 4).astype(jnp.int32)
                hends = (pb[:, 0] | (pb[:, 1] << 8) | (pb[:, 2] << 16)
                         | (pb[:, 3] << 24))
            return decode(stream, seg_bit_pos, jnp.asarray(nm_const),
                          perm, rank, hends)

        if _raw:
            return decode_packed
        return jax.jit(decode_packed)

    if _raw:
        return decode
    return jax.jit(decode)


def _soa_backend(plan: ScanPlan, coeffs, planar: bool = False,
                 _stop: str | None = None):
    """Lane-minor (struct-of-arrays) back-end: dequant + IDCT + level
    shift as 64 full-lane [N] vectors per component.

    The per-component graphs (batch.py::_component_plane) carry
    [B, bv, bh, 8, 8] int32 tensors whose minor dimension is 8.  Here
    the block axis (hundreds of thousands of blocks) is minor for
    the whole butterfly: ONE int32 transpose puts the 64 coefficient
    positions major, the Wang IDCT (idct.zig:77-201 semantics, exact)
    runs as elementwise math over 64 [N]-wide vectors, and one uint8
    transpose assembles raster planes.  Dequant is a scalar-constant
    multiply per position (decoder.zig:1564-1567); level shift + clamp
    per decoder.zig:1611-1633; chroma upsample + exact YCbCr->RGB
    unchanged (full-lane [B, H, W] planes).
    """
    import jax.numpy as jnp

    from ..ops.idct import _butterfly_col_list, _butterfly_row_list
    from ..ops.ycbcr import upsample_chroma_jnp, ycbcr_to_rgb8_jnp

    B, mxx, myy, bpm = plan.batch, plan.mxx, plan.myy, plan.bpm
    m_pad = plan.n_segs * plan.seg_mcus  # >= n_mcu (last segment padding)
    dc_row = None
    if isinstance(coeffs, tuple):  # split16: (int32 DC row, int16 AC store)
        dcv, ac16 = coeffs
        dc_row = dcv.reshape(bpm, B, m_pad)
        xt = ac16.reshape(64, bpm, B, m_pad)
    elif coeffs.ndim == 2:  # [64, bpm*B*m_pad] slot-major lanes (_soa_out)
        xt = coeffs.reshape(64, bpm, B, m_pad).astype(jnp.int32)
    else:  # legacy [L1, nblk, 64] (slot minor): one int32 relayout
        x = coeffs.reshape(B, m_pad, bpm, 64).astype(jnp.int32)
        xt = jnp.transpose(x, (3, 2, 0, 1))  # [64, bpm, B, m_pad]
    planes = []
    s0 = 0
    for c in range(plan.ncomp):
        hc, vc = plan.hv[c]
        nb = hc * vc
        q = plan.quants[c]
        # cols[p]: [nb, B, m_pad] int32, a contiguous major-axis view;
        # dequant is a scalar-constant multiply (decoder.zig:1564-1567)
        cols = [
            xt[p, s0 : s0 + nb].astype(jnp.int32) * jnp.int32(int(q[p]))
            for p in range(64)
        ]
        if dc_row is not None:
            cols[0] = dc_row[s0 : s0 + nb] * jnp.int32(int(q[0]))
        rows_out = [
            _butterfly_row_list([cols[8 * r + cc] for cc in range(8)], jnp)
            for r in range(8)
        ]
        out = [None] * 64
        for cc in range(8):
            colres = _butterfly_col_list(
                [rows_out[r][cc] for r in range(8)], jnp
            )
            for r in range(8):
                out[8 * r + cc] = colres[r]
        pix = jnp.stack(
            [jnp.clip(o + jnp.int32(128), 0, 255).astype(jnp.uint8) for o in out]
        )  # [64, nb, B, m_pad] uint8
        if _stop == "pix":  # debug/profiling: skip the raster relayout
            planes.append(pix)
            s0 += nb
            continue
        # [pr, pc, sv, sh, B, m] -> [B, m, sv, pr, sh, pc], then drop the
        # last-segment padding on the now-major MCU axis and rasterize
        p6 = pix.reshape(8, 8, vc, hc, B, m_pad)
        p6 = jnp.transpose(p6, (4, 5, 2, 0, 3, 1))[:, : plan.n_mcu]
        p6 = p6.reshape(B, myy, mxx, vc, 8, hc, 8)
        plane = jnp.transpose(p6, (0, 1, 3, 4, 2, 5, 6)).reshape(
            B, myy * vc * 8, mxx * hc * 8
        )
        planes.append(plane)
        s0 += nb
    if _stop in ("pix", "planes"):  # debug/profiling: truncated graphs
        return planes[0]
    y = planes[0][:, : plan.height, : plan.width]
    if plan.ncomp == 1:
        return y
    hf = plan.hv[0][0] // plan.hv[1][0]
    vf = plan.hv[0][1] // plan.hv[1][1]
    if plan.color == "rgb":
        # convertToRGB (decoder.zig:751-783): planes interleave directly
        g = upsample_chroma_jnp(planes[1], hf, vf, plan.height, plan.width)
        b = upsample_chroma_jnp(planes[2], hf, vf, plan.height, plan.width)
        chans = [y, g, b]
        return jnp.stack(chans, axis=1 if planar else -1)
    if plan.ncomp == 4 and plan.color == "cmyk":
        # raw CMYK (decoder.zig:852-901): 255-v interleave, 2x2 upsample
        # for subsampled components
        chans = []
        for c in range(4):
            p = planes[c]
            if plan.hv[c] != plan.hv[0]:
                p = upsample_chroma_jnp(p, 2, 2, plan.height, plan.width)
            else:
                p = p[:, : plan.height, : plan.width]
            chans.append(jnp.uint8(255) - p)
        return jnp.stack(chans, axis=1 if planar else -1)
    cb = upsample_chroma_jnp(planes[1], hf, vf, plan.height, plan.width)
    cr = upsample_chroma_jnp(planes[2], hf, vf, plan.height, plan.width)
    if _stop == "ups":  # debug/profiling: planes + upsample, no color
        return cb
    r, g, b = ycbcr_to_rgb8_jnp(y, cb, cr)
    if _stop == "rgbr":  # debug/profiling: full color math, no stack
        return r
    if plan.ncomp == 4:  # YCCK (applyBlack, decoder.zig:811-846)
        k = planes[3][:, : plan.height, : plan.width]
        chans = [r, g, b, jnp.uint8(255) - k]
        return jnp.stack(chans, axis=1 if planar else -1)
    if planar:
        # [B, 3, H, W]: W stays the minor dim.  An interleaved
        # [B, H, W, 3] device tensor tiles its minor dim of 3 up to the
        # 128-lane register row — a planar output sidesteps that pad on
        # every store; hosts interleave after the fetch if needed.
        return jnp.stack([r, g, b], axis=1)
    return jnp.stack([r, g, b], axis=-1)


def _merged_backend(plan: ScanPlan, coeffs):
    """Dequant + ONE IDCT over every block of every component + uint8
    plane assembly + chroma upsample + exact YCbCr->RGB.

    Compared with coefficients_to_grids + per-component graphs, the
    MCU-order -> raster relayout happens once on uint8 PIXELS (4x fewer
    bytes than int32 coefficients) and all components ride one IDCT
    kernel (the per-slot quant table is a baked [bpm, 64] constant).
    Level shift + clamp per decoder.zig:1611-1633; color math is the
    exact integer conversion (color.zig:95-113).
    """
    import jax.numpy as jnp

    from ..ops.idct import _col_pass, _row_pass
    from ..ops.ycbcr import upsample_chroma_jnp, ycbcr_to_rgb8_jnp

    B, mxx, myy, bpm = plan.batch, plan.mxx, plan.myy, plan.bpm
    x = coeffs.reshape(B, plan.n_segs * plan.seg_mcus, bpm, 64)
    x = x[:, : plan.n_mcu].astype(jnp.int32)
    q_slot = np.stack([plan.quants[c] for c in plan.comp_of_slot])
    deq = x * jnp.asarray(q_slot)[None, None]
    blocks = deq.reshape(B, plan.n_mcu, bpm, 8, 8)
    out = _col_pass(_row_pass(blocks, jnp), jnp)
    pix = jnp.clip(out + jnp.int32(128), 0, 255).astype(jnp.uint8)
    planes = []
    s0 = 0
    for c in range(plan.ncomp):
        hc, vc = plan.hv[c]
        nb = hc * vc
        xc = pix[:, :, s0 : s0 + nb].reshape(B, myy, mxx, vc, hc, 8, 8)
        planes.append(
            jnp.transpose(xc, (0, 1, 3, 5, 2, 4, 6)).reshape(
                B, myy * vc * 8, mxx * hc * 8
            )
        )
        s0 += nb
    y = planes[0][:, : plan.height, : plan.width]
    if plan.ncomp == 1:
        return y
    hf = plan.hv[0][0] // plan.hv[1][0]
    vf = plan.hv[0][1] // plan.hv[1][1]
    cb = upsample_chroma_jnp(planes[1], hf, vf, plan.height, plan.width)
    cr = upsample_chroma_jnp(planes[2], hf, vf, plan.height, plan.width)
    r, g, b = ycbcr_to_rgb8_jnp(y, cb, cr)
    return jnp.stack([r, g, b], axis=-1)


# ------------------------------------------------------------- assembly


class DeviceJpegDecoder:
    """Full on-chip baseline JPEG decode: bytes -> device RGB8 [B, H, W, 3].

    Host work is marker walk + de-stuff + upload (~memcpy speed); entropy
    decode, dequant, IDCT, chroma upsample and color conversion all run on
    the chip.  Requires restart markers (DRI > 0) — they are the natural
    parallel boundary (decoder.zig:1432-1452) — and shared geometry +
    Huffman/quant tables across the batch (one compiled program per
    (geometry, tables, batch, size-bucket)).

    Output is sample-exact with the host decoder (same Wang IDCT, same
    branchless YCbCr clamp semantics as color.zig:95-113).
    """

    def __init__(self, *, k_syms: int | None = None, max_steps: int = 16384,
                 mesh=None, win_words: int | None = None,
                 k1_syms: int | None = None, win1_words: int | None = None,
                 packed: bool | None = None, merged_backend: bool = False,
                 soa_backend: bool | None = None,
                 split_win: bool | None = None, planar: bool = False,
                 i16: bool | None = None, p1_i16: bool | None = None,
                 bins: int | None = None):
        self.k_syms = k_syms
        self.max_steps = max_steps
        self.win_words = win_words
        self.k1_syms = k1_syms
        self.win1_words = win1_words
        self.split_win = split_win
        self.i16 = i16
        self.p1_i16 = p1_i16
        self.bins = bins  # pass-1 straggler bins (see build_decode_fn)
        # planar=True: fused decode returns [B, 3, H, W] (color), minor
        # dim W instead of 3; gray is unaffected
        self.planar = planar
        self.mesh = mesh  # jax.sharding.Mesh with a "batch" axis, or None
        # one-buffer upload (stream ++ offsets).  With a mesh the buffer
        # becomes [ndev, stream ++ local offsets] sharded on axis 0 and
        # the entropy pass runs under shard_map (lanes per device).
        self.packed = (mesh is None) if packed is None else packed
        # one-IDCT + uint8-relayout back-end — kept A/B-able, off by
        # default
        self.merged_backend = merged_backend
        # lane-minor SoA back-end (see _soa_backend); default on
        self.soa_backend = True if soa_backend is None else soa_backend
        if merged_backend:
            self.soa_backend = False
        self._decode_fns: dict = {}
        self._backend_fns: dict = {}

    def _put(self, plan: ScanPlan):
        """Upload the plan; with a mesh, segment lanes shard over "batch"
        (the stream is replicated: every chip reads only its lanes' bytes
        but the flat buffer is shared — restart segments are embarrassingly
        parallel, so no collectives are needed until the gather phase)."""
        import jax

        if self.mesh is None:
            if self.packed:
                return (jax.device_put(plan.packed),)
            return (
                jax.device_put(plan.stream),
                jax.device_put(plan.seg_bit_pos),
                jax.device_put(plan.seg_n_mcu),
            )
        from jax.sharding import NamedSharding, PartitionSpec as P

        ndev = self.mesh.shape["batch"]
        if (plan.batch * plan.n_segs) % ndev:
            raise ValueError(
                f"jpeg: the mesh batch axis ({ndev}) must divide the lane "
                f"count ({plan.batch} images x {plan.n_segs} segments); "
                "pad the batch"
            )
        if self.packed:
            L = plan.batch * plan.n_segs
            Lc = L // ndev
            cap = plan.stream.shape[0]
            rows = np.empty((ndev, cap + 4 * Lc), np.uint8)
            rows[:, :cap] = plan.stream
            rows[:, cap:] = (
                plan.seg_bit_pos.astype("<i4").view(np.uint8).reshape(ndev, 4 * Lc)
            )
            return (
                jax.device_put(
                    rows, NamedSharding(self.mesh, P("batch", None))
                ),
            )
        repl = NamedSharding(self.mesh, P())
        lanes = NamedSharding(self.mesh, P("batch"))
        return (
            jax.device_put(plan.stream, repl),
            jax.device_put(plan.seg_bit_pos, lanes),
            jax.device_put(plan.seg_n_mcu, lanes),
        )

    def decode_coefficients(self, plan: ScanPlan):
        """Run the entropy kernel: -> (coeffs [L, nblk, 64] int16, ok)."""
        key = (plan.cache_key, int(plan.stream.shape[0]), self.mesh is not None,
               self.packed)
        fn = self._decode_fns.get(key)
        if fn is None:
            fn = build_decode_fn(plan, k_syms=self.k_syms, max_steps=self.max_steps,
                                 win_words=self.win_words, k1_syms=self.k1_syms,
                                 win1_words=self.win1_words,
                                 packed=self.packed, split_win=self.split_win,
                                 mesh=self.mesh if self.packed else None,
                                 p1_i16=self.p1_i16, bins=self.bins)
            self._decode_fns[key] = fn
        return fn(*self._put(plan))

    def _backend(self, plan: ScanPlan):
        import jax
        import jax.numpy as jnp

        key = plan.cache_key
        fn = self._backend_fns.get(key)
        if fn is None:
            quants = [
                jnp.asarray(np.stack([plan.quants[c]] * plan.batch))
                for c in range(plan.ncomp)
            ]

            @jax.jit
            def run(coeffs):
                return _grids_graph(
                    plan, coefficients_to_grids(plan, coeffs), quants
                )

            fn = run
            self._backend_fns[key] = fn
        return fn

    def _fused(self, plan: ScanPlan):
        """One compiled program: entropy decode + dequant + IDCT +
        upsample + color convert (no intermediate HBM roundtrip)."""
        import jax
        import jax.numpy as jnp

        key = ("fused", plan.cache_key, int(plan.stream.shape[0]),
               self.mesh is not None, self.packed, self.merged_backend,
               self.soa_backend, self.planar, self.i16,
               self.p1_i16, self.bins)
        fn = self._decode_fns.get(key)
        if fn is None:
            # packed+mesh entropy runs under shard_map and emits legacy
            # [L, nblk, 64] coefficients; the SoA back-end relayouts those
            # itself (its coeffs.ndim == 3 branch).
            packed_mesh = self.packed and self.mesh is not None
            body = build_decode_fn(
                plan, k_syms=self.k_syms, max_steps=self.max_steps,
                win_words=self.win_words, k1_syms=self.k1_syms,
                win1_words=self.win1_words, packed=self.packed,
                split_win=self.split_win,
                coeff_dtype=jnp.int32, _raw=True,
                _soa_out=self.soa_backend and not packed_mesh,
                mesh=self.mesh if self.packed else None,
                i16=self.i16, p1_i16=self.p1_i16, bins=self.bins,
            )

            if self.soa_backend:

                def fused(*args):
                    coeffs, ok = body(*args)
                    return _soa_backend(plan, coeffs,
                                        planar=self.planar), ok

            elif self.merged_backend:

                def fused(*args):
                    coeffs, ok = body(*args)
                    return _merged_backend(plan, coeffs), ok

            else:
                quants = [
                    np.stack([plan.quants[c]] * plan.batch)
                    for c in range(plan.ncomp)
                ]

                def fused(*args):
                    coeffs, ok = body(*args)
                    rgb = _grids_graph(
                        plan, coefficients_to_grids(plan, coeffs),
                        [jnp.asarray(q) for q in quants],
                    )
                    return rgb, ok

            fn = jax.jit(fused)
            self._decode_fns[key] = fn
        return fn

    def decode(self, datas: list[bytes]):
        """bytes -> (rgb_or_gray device array, ok device scalar).

        ``ok`` is left on device so callers can pipeline; materialize it
        (bool(ok)) to validate the batch decoded cleanly.
        """
        from ..utils import metrics, trace

        with trace("jpeg_onchip.prep"):
            plan = prep_batch(datas)
        metrics.count("jpeg_onchip.images", len(datas))
        metrics.count(
            "jpeg_onchip.megapixels",
            len(datas) * plan.width * plan.height / 1e6,
        )
        with trace("jpeg_onchip.upload"):
            bufs = self._put(plan)
        with trace("jpeg_onchip.dispatch"):
            return self._fused(plan)(*bufs)


def prep_batch_host_index(datas: list[bytes],
                          cap_hint: int | None = None) -> ScanPlan:
    """Restart-free batches: host C++ INDEX scan -> per-block bit ends.

    Speculative chunk self-sync converges one chunk per round on
    interleaved restart-free baseline JPEG (RESULTS.md round-3 profile:
    360 serial rounds), so the fast path for such streams decodes
    symbol LENGTHS on the host (runtime.zpix_baseline_index_scan:
    LUT16, thread-per-image, no coefficient writes) and ships
    [stream ++ per-block end offsets] to the device value pass — the
    same pass-2 + SoA back-end as the restart path, whose `agree`
    verification re-derives every end bit-for-bit.

    Packed layout: [flat stream | seg_bit_pos i32 [B] | ends i32
    [B * n_mcu * bpm]] with one segment per image (n_segs=1).
    """
    import ctypes
    from concurrent.futures import ThreadPoolExecutor

    from .. import runtime

    lib = runtime.get_lib()
    if lib is None or not hasattr(lib, "zpix_baseline_index_scan"):
        raise UnsupportedError("jpeg: host-index path needs the native runtime")
    if not datas:
        raise ValueError("jpeg: empty batch")
    first = None
    streams = []
    for data in datas:
        sof, quants, huffs, dri, sel, scan_start, color = _parse_headers(data)
        key = (sof, tuple(q.tobytes() if q is not None else None for q in quants),
               tuple(sorted((k, t.num_codes, tuple(t.vals), tuple(t.min_codes),
                             tuple(t.max_codes), tuple(t.vals_indices))
                            for k, t in huffs.items())), dri, tuple(sel), color)
        if first is None:
            first = (key, sof, quants, huffs, dri, sel, color)
        elif key != first[0]:
            raise UnsupportedError("jpeg: batch must share geometry and tables")
        stream, seg_starts = _destuff(data, scan_start)
        if len(seg_starts) != 1 or int(seg_starts[0]) != 0:
            raise UnsupportedError(
                "jpeg: host-index path covers restart-free streams "
                "(use prep_batch/DeviceJpegDecoder for DRI > 0)"
            )
        streams.append(stream)

    _, sof, quants, huffs, dri, sel, color = first
    w, h, nc, comps = sof
    h0, v0 = comps[0][1], comps[0][2]
    mxx = (w + 8 * h0 - 1) // (8 * h0)
    myy = (h + 8 * v0 - 1) // (8 * v0)
    n_mcu = mxx * myy
    comp_of_slot = []
    for c in range(nc):
        comp_of_slot += [c] * (comps[c][1] * comps[c][2])
    bpm = len(comp_of_slot)
    nblk = n_mcu * bpm
    B = len(datas)

    order = []
    for want_cls in (1, 0):
        for c, td, ta in sel:
            kk = (want_cls, ta if want_cls else td)
            if kk not in order:
                order.append(kk)
    tid_of = {kk: i for i, kk in enumerate(order)}
    cmp = CmpTables([huffs[kk] for kk in order])
    sel_by_comp = {i: (td, ta) for i, (_, td, ta) in enumerate(sel)}
    tid_dc = tuple(tid_of[(0, sel_by_comp[c][0])] for c in range(nc))
    tid_ac = tuple(tid_of[(1, sel_by_comp[c][1])] for c in range(nc))

    # marshal the canonical tables for the C index scan ([8]: dc|ac)
    huff_arr = (runtime.HuffTableC * 8)()
    for (cls, tid), tab in huffs.items():
        ct = huff_arr[cls * 4 + tid]
        ct.min_codes[:] = tab.min_codes
        ct.max_codes[:] = tab.max_codes
        ct.vals_indices[:] = tab.vals_indices
        ct.vals[:] = tab.vals
        ct.num_codes = tab.num_codes
    slot_dc = np.array([sel_by_comp[c][0] for c in comp_of_slot], np.int32)
    slot_ac = np.array([sel_by_comp[c][1] for c in comp_of_slot], np.int32)

    ends = np.empty((B, nblk), np.int32)
    padded = [
        np.ascontiguousarray(np.concatenate([s, np.zeros(8, np.uint8)]))
        for s in streams
    ]

    def one(b):
        endb = ctypes.c_int64(0)
        rc = lib.zpix_baseline_index_scan(
            padded[b].ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            len(streams[b]), huff_arr,
            slot_dc.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            slot_ac.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            bpm, n_mcu,
            ends[b].ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.byref(endb),
        )
        return rc

    with ThreadPoolExecutor(max_workers=min(B, os.cpu_count() or 2)) as ex:
        rcs = list(ex.map(one, range(B)))
    bad = [rc for rc in rcs if rc != 0]
    if bad:
        raise FormatError(f"jpeg: host index scan failed (rc={bad[0]})")

    offs, total = [], 0
    for s in streams:
        offs.append(total)
        total += (len(s) + 7) // 8 * 8
    cap = 1 << max(12, (max(total + 16, cap_hint or 0) - 1).bit_length())
    flat = np.zeros(cap, np.uint8)
    for s, o in zip(streams, offs):
        flat[o : o + len(s)] = s
    seg_bit_pos = (np.asarray(offs, np.int64) * 8).astype(np.int64)
    ends_abs = ends + (seg_bit_pos[:, None]).astype(np.int32)
    max_seg_bits = 1 << max(10, (8 * max(len(s) for s in streams) - 1)
                            .bit_length())
    packed = np.concatenate([
        flat, seg_bit_pos.astype("<i4").view(np.uint8),
        ends_abs.astype("<i4").reshape(-1).view(np.uint8),
    ])
    ratio = "gray"
    if nc >= 3:
        hr = comps[0][1] // comps[1][1]
        vr = comps[0][2] // comps[1][2]
        ratio = {0x11: "444", 0x12: "440", 0x21: "422",
                 0x22: "420", 0x41: "411", 0x42: "410"}[(hr << 4) | vr]
    return ScanPlan(
        width=w, height=h, ncomp=nc,
        hv=tuple((c[1], c[2]) for c in comps), ratio=ratio,
        mxx=mxx, myy=myy, bpm=bpm, comp_of_slot=tuple(comp_of_slot),
        n_mcu=n_mcu, seg_mcus=n_mcu, n_segs=1,
        quants=[quants[c[3]] for c in comps],
        cmp=cmp, tid_dc=tid_dc, tid_ac=tid_ac,
        stream=flat, seg_bit_pos=seg_bit_pos,
        seg_n_mcu=np.full(B, n_mcu, np.int32),
        max_seg_bits=max_seg_bits, batch=B,
        cache_key=(first[0], B, max_seg_bits, "host_index"),
        packed=packed, color=color,
    )


class HostIndexJpegDecoder(DeviceJpegDecoder):
    """Restart-free JPEG: host C++ index pass + device value pass.

    The chip-resident speculative path (SyncJpegDecoder) is provably
    serial on interleaved restart-free streams; this decoder is the
    framework's FAST path for them — host decodes lengths only, the
    device decodes every block's values in parallel and verifies the
    host offsets exactly (pass-2 `agree`).
    """

    def __init__(self, **kw):
        kw.setdefault("packed", True)
        super().__init__(**kw)

    def _fused(self, plan: ScanPlan):
        import jax
        import jax.numpy as jnp

        key = ("fused_hi", plan.cache_key, int(plan.stream.shape[0]),
               self.planar, self.i16)
        fn = self._decode_fns.get(key)
        if fn is None:
            body = build_decode_fn(
                plan, k_syms=self.k_syms, max_steps=self.max_steps,
                win_words=self.win_words, packed=True, ends_in=True,
                split_win=self.split_win, coeff_dtype=jnp.int32,
                _raw=True, _soa_out=True, i16=self.i16,
            )

            def fused(*args):
                coeffs, ok = body(*args)
                return _soa_backend(plan, coeffs, planar=self.planar), ok

            fn = jax.jit(fused)
            self._decode_fns[key] = fn
        return fn

    def decode(self, datas: list[bytes]):
        from ..utils import metrics, trace

        with trace("jpeg_hostindex.prep"):
            plan = prep_batch_host_index(datas)
        metrics.count("jpeg_hostindex.images", len(datas))
        with trace("jpeg_hostindex.upload"):
            bufs = self._put(plan)
        with trace("jpeg_hostindex.dispatch"):
            return self._fused(plan)(*bufs)


def _grids_graph(plan: ScanPlan, grids, quants):
    """Dense back-end over per-component grids, dispatched by color space
    (gray/YCbCr/RGB/YCCK/CMYK — decoder.zig:361-370 post-scan routing)."""
    import jax.numpy as jnp

    from .batch import (
        _cmyk_graph, _gray_graph, _rgb_graph, _ycbcr_graph, _ycck_graph,
    )

    g = [x.astype(jnp.int32) for x in grids]
    kw = dict(height=plan.height, width=plan.width)
    if plan.ncomp == 1:
        return _gray_graph(g[0], quants[0], **kw)
    if plan.color == "rgb":
        return _rgb_graph(*g, *quants, ratio=plan.ratio, **kw)
    if plan.color == "ycck":
        return _ycck_graph(*g, *quants, ratio=plan.ratio, **kw)
    if plan.color == "cmyk":
        sub = tuple(hv != plan.hv[0] for hv in plan.hv)
        return _cmyk_graph(*g, *quants, sub=sub, **kw)
    return _ycbcr_graph(*g, *quants, ratio=plan.ratio, **kw)


def coefficients_to_grids(plan: ScanPlan, coeffs):
    """[B*n_segs, seg_mcus*bpm, 64] -> per-component [B, bv, bh, 64].

    Pure reshape/transpose: lanes are MCU-raster order and slots follow
    the T.81 interleave (left-to-right, top-to-bottom within the MCU), so
    no gathers are needed for h,v in {1,2} x {1,2}.
    """
    import jax.numpy as jnp

    B, mxx, myy = plan.batch, plan.mxx, plan.myy
    x = coeffs.reshape(B, plan.n_segs * plan.seg_mcus, plan.bpm, 64)
    x = x[:, : plan.n_mcu]  # drop tail padding of the last segment
    out = []
    slot0 = 0
    for c in range(plan.ncomp):
        hc, vc = plan.hv[c]
        nb = hc * vc
        xc = x[:, :, slot0 : slot0 + nb, :]
        xc = xc.reshape(B, myy, mxx, vc, hc, 64)
        xc = jnp.transpose(xc, (0, 1, 3, 2, 4, 5)).reshape(
            B, myy * vc, mxx * hc, 64
        )
        out.append(xc)
        slot0 += nb
    return out
