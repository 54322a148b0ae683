"""On-chip progressive-JPEG entropy decode: SOF2 scans on SIMD lanes.

The reference decodes progressive scans bit-serially on the host
(decoder.zig:1362-1412 spectral selection, :1459-1549 refinement); round
2 kept per-scan Huffman on the host and shipped sparse deltas up.  Here
the "first" scans run ON THE CHIP with the same speculative-chunk
fixed-point machinery as the restart-free baseline decoder
(device_entropy_sync.py, after arXiv:2111.09219):

* **DC first scans** (Ss=0, Ah=0, interleaved or single-component) —
  every block is exactly ONE Huffman symbol + extend bits, so the index
  scan IS the value scan: chunk lanes record (block, diff) pairs
  directly; the per-component predictor chains (decoder.zig:1366-1376)
  are an exclusive cumsum, and ``b[0] = dc << Al``.
* **AC first scans** (Ss>0, Ah=0, single component) — non-interleaved
  lanes over the component's VALID blocks (the reference skips blocks
  whose 8px origin falls outside the image, decoder.py:528; progressive
  is the only path where edge blocks stay undecoded).  Lane state is
  (bit, k, mid-block); EOB runs (decoder.py:571-576) resolve in ONE
  step — the run's blocks consume no bits, so a run never spans chunks
  and block advances accumulate per chunk.  A value pass (one lane per
  valid block, eob-covered lanes idle) re-decodes each data block into
  its own [64] row at ``val << Al``; verification requires every value
  lane to land exactly on the index scan's block end.
* **DC refinement scans** (Ss=0, Ah>0) — one RAW bit per block, no
  Huffman at all: ``unpackbits`` + ``row0 |= bit << Al``
  (decoder.py:721-726).

* **AC refinement scans** (Ss>0, Ah>0, single component) — the round-4
  host-INDEX/device-VALUE split: a C++ pass
  (runtime.zpix_prog_refine_index) walks the scan's bits maintaining
  only per-block nonzero masks (seeded by ONE store fetch at the first
  refinement, then evolved host-side) and emits each block's exact
  entry bit offset + entry-EOB flag; the device value pass
  (build_ac_refine_fn) then decodes every block independently,
  mask-parallel against the resident store.  With it, the ENTIRE
  standard libjpeg scan script decodes with zero host-tail scans
  (test_onchip_ac_refine_zero_host_tail).

Why AC refinement cannot use the speculative-chunk machinery (design
note): its bit consumption is gated on each block's nonzero pattern —
every nonzero coefficient crossed costs one correction bit, and
EOB-covered blocks still consume bits.  A speculative lane would need
its absolute block index to gather the right mask, and a wrong guess
cannot self-synchronize the way plain Huffman lookahead does (the mask
gather poisons every subsequent symbol), so fixed-point convergence
degenerates to one chunk per round — serial.  Hence the index/value
split above; the host tail (store fetch + sparse deltas) remains the
fallback for nonstandard scripts and index-pass errors.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..codecs.jpeg.tables import UNZIG, HuffTable
from ..errors import FormatError, UnsupportedError
from .device_entropy import (
    CmpTables,
    _bits_at,
    _make_sym_decoder,
    _select_by_index,
)


# ---------------------------------------------------------------- parse


@dataclass
class ScanInfo:
    comps: tuple  # component indices (0-based) in scan order
    td: tuple  # DC table id per scan component
    ta: tuple  # AC table id per scan component
    ss: int
    se: int
    ah: int
    al: int
    stream: np.ndarray  # destuffed entropy bytes of this scan
    huffs: dict = None  # (tc, th) -> HuffTable snapshot at this scan

    @property
    def kind(self) -> str:
        if self.ss == 0:
            return "dc_first" if self.ah == 0 else "dc_refine"
        return "ac_first" if self.ah == 0 else "ac_refine"


@dataclass
class ProgPlan:
    width: int
    height: int
    ncomp: int
    hv: tuple
    mxx: int
    myy: int
    quants: list  # [ncomp] natural-order int32[64]
    scans: list  # [ScanInfo]
    ratio: str
    tq: tuple  # per-component quant selector


def _destuff_scan(data: bytes, start: int):
    """Destuff one scan's entropy bytes: FF00 -> FF, stop at the first
    real marker (refinement scans end at the next DHT/SOS/EOI).  RST
    markers inside the scan -> UnsupportedError (progressive + DRI falls
    back to the host path)."""
    d = np.frombuffer(data, np.uint8)[start:]
    ff = np.flatnonzero(d[:-1] == 0xFF)
    nxt = d[ff + 1]
    real = ff[(nxt != 0x00) & (nxt != 0xFF)]
    end = int(real[0]) if len(real) else len(d)
    rst_mask = (nxt >= 0xD0) & (nxt <= 0xD7)
    if len(real) and rst_mask[np.searchsorted(ff, real[0])]:
        raise UnsupportedError("jpeg: progressive restart intervals on-chip")
    stuffed = ff[(nxt == 0x00)]
    stuffed = stuffed[stuffed < end]
    keep = np.ones(end, bool)
    keep[stuffed + 1] = False
    return d[:end][keep], start + end


def parse_progressive(data: bytes) -> ProgPlan:
    """Full marker walk of one SOF2 stream: geometry + per-scan params,
    table snapshots, and destuffed entropy segments."""
    if data[:2] != b"\xff\xd8":
        raise FormatError("jpeg: missing SOI")
    pos = 2
    quants = [None] * 4
    huffs: dict = {}
    sof = None
    scans: list = []
    while pos < len(data) - 1:
        if data[pos] != 0xFF:
            pos += 1
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
        if marker == 0xC2:
            prec = body[0]
            if prec != 8:
                raise UnsupportedError("jpeg: only 8-bit precision")
            h, w, nc = (body[1] << 8) | body[2], (body[3] << 8) | body[4], body[5]
            comps = []
            for i in range(nc):
                comps.append(
                    (body[6 + 3 * i], body[7 + 3 * i] >> 4,
                     body[7 + 3 * i] & 15, body[8 + 3 * i])
                )
            sof = (w, h, nc, tuple(comps))
        elif marker in (0xC0, 0xC1):
            raise UnsupportedError("jpeg: baseline stream; use the baseline path")
        elif marker in (0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF):
            raise UnsupportedError("jpeg: only progressive DCT here")
        elif marker == 0xC4:
            o = 0
            while o < len(body):
                tc, th = body[o] >> 4, body[o] & 15
                counts = list(body[o + 1 : o + 17])
                total = sum(counts)
                t = HuffTable()
                t.build(counts, bytes(body[o + 17 : o + 17 + total]))
                huffs[(tc, th)] = t
                o += 17 + total
        elif marker == 0xDB:
            o = 0
            while o < len(body):
                pq, tq = body[o] >> 4, body[o] & 15
                if pq == 0:
                    q = np.array(list(body[o + 1 : o + 65]), np.int32)
                    o += 65
                else:
                    raw = body[o + 1 : o + 129]
                    q = np.array(
                        [(raw[2 * i] << 8) | raw[2 * i + 1] for i in range(64)],
                        np.int32,
                    )
                    o += 129
                nat = np.zeros(64, np.int32)
                nat[UNZIG] = q
                quants[tq] = nat
        elif marker == 0xDD:
            if (body[0] << 8) | body[1]:
                raise UnsupportedError(
                    "jpeg: progressive restart intervals on-chip"
                )
        elif marker == 0xDA:
            if sof is None:
                raise FormatError("jpeg: SOS before SOF")
            ns = body[0]
            ids = tuple(c[0] for c in sof[3])
            cidx, tds, tas = [], [], []
            for i in range(ns):
                cs, tt = body[1 + 2 * i], body[2 + 2 * i]
                cidx.append(ids.index(cs))
                tds.append(tt >> 4)
                tas.append(tt & 15)
            ss = body[1 + 2 * ns]
            se = body[2 + 2 * ns]
            ahal = body[3 + 2 * ns]
            stream, endpos = _destuff_scan(data, pos + seg_len)
            scans.append(
                ScanInfo(
                    comps=tuple(cidx), td=tuple(tds), ta=tuple(tas),
                    ss=ss, se=se, ah=ahal >> 4, al=ahal & 15,
                    stream=stream, huffs=dict(huffs),
                )
            )
            pos = endpos
            continue
        pos += seg_len
    if sof is None or not scans:
        raise FormatError("jpeg: no SOF2/SOS")
    w, h, nc, comps = sof
    if nc == 1:
        # grayscale ignores declared sampling factors
        # (decoder.zig:546-561 normalizes (h, v) to (1, 1))
        cid, _, _, tq = comps[0]
        comps = ((cid, 1, 1, tq),)
    h0, v0 = comps[0][1], comps[0][2]
    ratio = "gray"
    if nc >= 3:
        hr, vr = h0 // comps[1][1], v0 // comps[1][2]
        ratio = {0x11: "444", 0x12: "440", 0x21: "422",
                 0x22: "420", 0x41: "411", 0x42: "410"}.get((hr << 4) | vr)
        if ratio is None:
            raise UnsupportedError("jpeg: unsupported sampling")
    return ProgPlan(
        width=w, height=h, ncomp=nc,
        hv=tuple((c[1], c[2]) for c in comps),
        mxx=(w + 8 * h0 - 1) // (8 * h0),
        myy=(h + 8 * v0 - 1) // (8 * v0),
        quants=[quants[c[3]] for c in comps],
        scans=scans, ratio=ratio, tq=tuple(c[3] for c in comps),
    )


# ---------------------------------------------------------------- kernels


def _window(jnp, stream, W):
    """Stacked [N, W] big-endian u32 windows at every byte offset."""
    s = stream.astype(jnp.uint32)
    n = stream.shape[0] - 4 * W
    b = [s[i : n + i] for i in range(4 * W)]
    win = jnp.stack(
        [
            (b[4 * j] << 24) | (b[4 * j + 1] << 16) | (b[4 * j + 2] << 8)
            | b[4 * j + 3]
            for j in range(W)
        ],
        axis=-1,
    )
    return win, n


def _receive_extend(jnp, w, pos, size):
    """RECEIVE+EXTEND, branch-free (T.81 F.2.2.1, decoder.py:250-263)."""
    raw = _bits_at(jnp, w, pos, jnp.clip(size, 0, 16)).astype(jnp.int32)
    raw = jnp.where(size > 0, raw, 0)
    sz = jnp.clip(size, 0, 16)
    bias = jnp.where(size > 0, (jnp.int32(1) << sz) - 1, 0)
    top_clear = raw < (jnp.int32(1) << jnp.clip(size - 1, 0, 15))
    return jnp.where(size > 0, jnp.where(top_clear, raw - bias, raw), 0)


def _make_ac_sym_step(jnp, decode_sym, mt_one, se):
    """One AC spectral-selection symbol (shared by the speculative index
    scan, the speculative value pass, and the host-index value pass —
    the host C++ index walk zpix_prog_ac_first_index mirrors these exact
    length semantics, including the overflow rule)."""

    def sym_step(w, off, k, active):
        """Returns (consume, new_k, blk_done, skips, bad, ln_sel, sym).
        skips = extra blocks covered by an EOB run."""
        look16 = _bits_at(jnp, w, off, jnp.int32(16)).astype(jnp.int32)
        ln_sel, sym, bad = decode_sym(look16, mt_one)
        bad = active & bad
        r = sym >> 4
        size = sym & 15
        is_eob = (size == 0) & (r < 15)
        is_zrl = (size == 0) & (r == 15)
        k2_ = k + r
        overflow = (size > 0) & (k2_ > se)  # break BEFORE extend bits
        run_extra = _bits_at(
            jnp, w, off + ln_sel, jnp.clip(r, 0, 14)
        ).astype(jnp.int32)
        run_extra = jnp.where(is_eob & (r > 0), run_extra, 0)
        eob_total = jnp.where(is_eob, (1 << jnp.clip(r, 0, 14)) | run_extra, 0)
        consume = jnp.where(
            is_eob, ln_sel + jnp.where(r > 0, r, 0),
            jnp.where(is_zrl | overflow, ln_sel, ln_sel + size),
        )
        new_k = jnp.where(
            is_zrl, k + 16,
            jnp.where(is_eob | overflow, k, k2_ + 1),
        )
        blk_done = is_eob | overflow | (new_k > se)
        skips = jnp.where(is_eob, eob_total - 1, 0)
        return consume, new_k, blk_done, skips, bad, ln_sel, sym

    return sym_step


def _make_ac_value_body(jax, jnp, win, n, W, sym_step, k2, se, invT,
                        off_lim, L2):
    """Per-valid-block AC value-pass loop body/cond (one lane per block,
    each decoding its own [start, end) bit span into a [64, L2] natural-
    order column).  Shared by the speculative path (offsets from the
    on-chip index scan) and the host-index path (offsets from
    zpix_prog_ac_first_index)."""

    def body2(st):
        (bit_pos, curT, k, done, err, steps) = st
        byte = jnp.clip(bit_pos >> 3, 0, n - 1)
        wW = win[byte]
        w = tuple(wW[:, i] for i in range(W))
        off0 = (bit_pos & 7).astype(jnp.int32)
        off = off0
        emits = []
        for _ in range(k2):
            active = (~done) & (off <= off_lim)
            consume, new_k, blk_done, _skips, bad, ln_sel, sym = (
                sym_step(w, off, k, active)
            )
            r = sym >> 4
            size = sym & 15
            k_emit = k + r
            emit_ok = (size > 0) & (k_emit <= se)
            ext = _receive_extend(jnp, w, off + ln_sel, size)
            app = active & ~bad
            emits.append((
                jnp.where(app & emit_ok, ext, 0),
                jnp.clip(k_emit, 0, 63),
            ))
            k = jnp.where(app, new_k, k)
            off = jnp.where(app, off + consume, off)
            err = err | bad
            done = done | (app & blk_done) | bad
        curT = curT + sum(
            jnp.where(ek[None, :] == invT, ev[None, :], 0)
            for ev, ek in emits
        )
        bit_pos = bit_pos - off0 + off
        return (bit_pos, curT, k, done, err, steps + 1)

    def cond2(st):
        return (jnp.sum(st[3].astype(jnp.int32)) < L2) & (st[5] < 81)

    return body2, cond2


def build_dc_first_fn(
    *, batch: int, n_chunks: int, chunk_bytes: int, cmp: CmpTables,
    tid_of_slot: tuple, nblk_total: int, k1: int = None, W: int = None,
    _raw: bool = False,
):
    """DC first scan (Ss=0, Ah=0): chunked speculative decode.

    Every block is one DC symbol + extend bits (decoder.py:543-554), so
    the chunk scan records (block-in-chunk, raw diff) pairs directly —
    no separate value pass.  tid_of_slot maps slot-in-MCU -> cmp table
    (len 1 for single-component scans, which have no slot cycling).

    Returns jit fn (stream, img_bit_start, img_bit_end) ->
    (diffs [B, nblk_total] int32, sizes_bad ok flag).
    """
    import jax
    import jax.numpy as jnp

    from .device_entropy import _DEF_K1, _DEF_W

    B, F = batch, n_chunks
    L = B * F
    C_BITS = chunk_bytes * 8
    bpm = len(tid_of_slot)
    k1 = k1 if k1 is not None else _DEF_K1
    W = W if W is not None else _DEF_W
    off_lim = 32 * W - 48
    mbc = 4 * chunk_bytes  # DC sym >= 2 bits incl. extend in practice
    inner_cap = (8 * chunk_bytes) // max(k1, 1) + 8
    rounds_cap = F + 2

    def decode(stream, img_bit_start, img_bit_end):
        win, n = _window(jnp, stream, W)
        decode_sym = _make_sym_decoder(jnp, cmp)
        img_start = img_bit_start.astype(jnp.int32)
        img_end = img_bit_end.astype(jnp.int32)
        lane_img = jnp.repeat(jnp.arange(B), F)
        lane_chunk = jnp.tile(jnp.arange(F), B)
        chunk_start = jnp.minimum(
            img_start[lane_img] + lane_chunk * C_BITS, img_end[lane_img]
        )
        chunk_end = jnp.minimum(chunk_start + C_BITS, img_end[lane_img])

        def scan_chunks(entries, record):
            e_bit, e_slot = entries

            def body(st):
                (bit_pos, slot, done, over, err_bit, vals, cnt, steps) = st
                byte = jnp.clip(bit_pos >> 3, 0, n - 1)
                wW = win[byte]
                w = tuple(wW[:, i] for i in range(W))
                off0 = (bit_pos & 7).astype(jnp.int32)
                off = off0
                base = (byte << 3).astype(jnp.int32)
                emits = []
                for _ in range(k1):
                    active = (~done) & (off <= off_lim)
                    look16 = _bits_at(jnp, w, off, jnp.int32(16)).astype(
                        jnp.int32
                    )
                    if len(tid_of_slot) == 1:
                        mt = [
                            True if t == tid_of_slot[0] else None
                            for t in range(cmp.ntab)
                        ]
                    else:
                        tid = _select_by_index(jnp, slot, tid_of_slot)
                        mt = [tid == t for t in range(cmp.ntab)]
                    ln_sel, sym, bad = decode_sym(look16, mt)
                    bad = active & (bad | (sym > 16))  # decoder.py:548-551
                    diff = _receive_extend(jnp, w, off + ln_sel, sym)
                    app = active & ~bad
                    if record:
                        emits.append((
                            jnp.clip(cnt, 0, mbc - 1),
                            jnp.where(app & (cnt < mbc), diff, 0),
                        ))
                        over = over | (app & (cnt >= mbc))
                    cnt = jnp.where(app, cnt + 1, cnt)
                    slot = jnp.where(app, slot + 1, slot)
                    slot = jnp.where(slot >= bpm, 0, slot)
                    off = jnp.where(app, off + ln_sel + sym, off)
                    err_bit = jnp.where(
                        bad, jnp.minimum(err_bit, base + off), err_bit
                    )
                    done = done | (base + off >= chunk_end) | bad
                bit_pos = bit_pos - off0 + off
                if record:
                    arb = jnp.arange(mbc)[None, :]
                    vals = vals + sum(
                        jnp.where(ci[:, None] == arb, cv[:, None], 0)
                        for ci, cv in emits
                    )
                return (bit_pos, slot, done, over, err_bit, vals, cnt,
                        steps + 1)

            def cond(st):
                return (jnp.sum(st[2].astype(jnp.int32)) < L) & (
                    st[7] < inner_cap
                )

            return jax.lax.while_loop(
                cond,
                body,
                (
                    e_bit,
                    e_slot,
                    e_bit >= chunk_end,
                    jnp.zeros(L, bool),
                    jnp.full(L, 2**30, jnp.int32),
                    jnp.zeros((L, mbc if record else 1), jnp.int32),
                    jnp.zeros(L, jnp.int32),
                    jnp.int32(0),
                ),
            )

        guess = (chunk_start, jnp.zeros(L, jnp.int32))

        def shift(exits):
            bit, slot = exits
            bit2 = bit.reshape(B, F)
            slot2 = slot.reshape(B, F)
            return (
                jnp.concatenate([img_start[:, None], bit2[:, :-1]], 1).reshape(L),
                jnp.concatenate(
                    [jnp.zeros((B, 1), jnp.int32), slot2[:, :-1]], 1
                ).reshape(L),
            )

        def sync_round(st):
            entries, _c, rounds = st
            sc = scan_chunks(entries, record=False)
            new_entries = shift((sc[0], sc[1]))
            chg = jnp.zeros((), bool)
            for a, bb in zip(new_entries, entries):
                chg = chg | jnp.any(a != bb)
            return (new_entries, chg, rounds + 1)

        st = (guess, jnp.ones((), bool), jnp.int32(0))
        st = jax.lax.while_loop(
            lambda s: s[1] & (s[2] < rounds_cap), sync_round, st
        )
        sc = scan_chunks(st[0], record=True)
        over, err_bit, vals, cnt = sc[3], sc[4], sc[5], sc[6]

        # assemble per-image block diffs in stream order
        cnt_img = cnt.reshape(B, F)
        total = jnp.sum(cnt_img, axis=1)
        # the decode runs into the encoder's 1-bit padding which may
        # parse as extra symbols or an invalid code; require AT LEAST
        # nblk_total blocks, ignore the tail, and tolerate decode errors
        # only inside the final 2 bytes (the padding region — same rule
        # as device_entropy_sync)
        total_ok = jnp.all(total >= nblk_total)
        err_ok = jnp.all(err_bit >= img_end[lane_img] - 16)
        base = jnp.cumsum(cnt_img, axis=1) - cnt_img
        g = jnp.arange(nblk_total)

        def per_image(base_b, vals_b):
            i_of_g = (
                jnp.searchsorted(base_b, g, side="right") - 1
            ).astype(jnp.int32)
            i_of_g = jnp.clip(i_of_g, 0, F - 1)
            j_of_g = g - base_b[i_of_g]
            rows = jnp.clip(i_of_g * mbc + j_of_g, 0, F * mbc - 1)
            return vals_b.reshape(F * mbc)[rows]

        diffs = jax.vmap(per_image)(base, vals.reshape(B, F, mbc))
        ok = jnp.all(sc[2]) & ~jnp.any(over) & total_ok & err_ok
        return diffs, ok

    if _raw:
        return decode
    import jax

    return jax.jit(decode)


def build_ac_first_fn(
    *, batch: int, n_chunks: int, chunk_bytes: int, cmp: CmpTables,
    tid: int, ss: int, se: int, nvalid: int, k1: int = None,
    k2: int = None, W: int = None, _raw: bool = False,
):
    """AC first scan (Ss>0, Ah=0, single component): chunked speculative
    index scan + per-block value pass.

    Semantics per decoder.py:556-578: blocks in component raster order
    over the VALID grid (nvalid blocks); an EOB symbol (size=0, r<15)
    ends the current block and skips ``(1<<r | receive(r)) - 1`` more —
    the skipped blocks consume no bits, so the whole run resolves inside
    the chunk that decoded the symbol and lane state is just (bit, k).

    Returns jit fn (stream, img_bit_start, img_bit_end) ->
    (coefT [64, B*nvalid] int32 natural-order values at <<Al applied by
    the caller, ok flag).
    """
    import jax
    import jax.numpy as jnp

    from .device_entropy import _DEF_K, _DEF_K1, _DEF_W

    B, F = batch, n_chunks
    L = B * F
    C_BITS = chunk_bytes * 8
    k1 = k1 if k1 is not None else _DEF_K1
    k2 = k2 if k2 is not None else _DEF_K
    W = W if W is not None else _DEF_W
    off_lim = 32 * W - 48
    mbc = 4 * chunk_bytes  # data blocks starting per chunk (>=2 bits each)
    inner_cap = (8 * chunk_bytes) // max(k1, 1) + 8
    rounds_cap = F + 2
    L2 = B * nvalid
    mt_one = [True if t == tid else None for t in range(cmp.ntab)]

    inv = np.zeros(64, np.int64)
    inv[UNZIG] = np.arange(64)
    invT_np = inv[:, None]

    def decode(stream, img_bit_start, img_bit_end):
        win, n = _window(jnp, stream, W)
        decode_sym = _make_sym_decoder(jnp, cmp)
        img_start = img_bit_start.astype(jnp.int32)
        img_end = img_bit_end.astype(jnp.int32)
        lane_img = jnp.repeat(jnp.arange(B), F)
        lane_chunk = jnp.tile(jnp.arange(F), B)
        chunk_start = jnp.minimum(
            img_start[lane_img] + lane_chunk * C_BITS, img_end[lane_img]
        )
        chunk_end = jnp.minimum(chunk_start + C_BITS, img_end[lane_img])

        sym_step = _make_ac_sym_step(jnp, decode_sym, mt_one, se)

        # ---------------- index scan (chunk lanes)
        def scan_chunks(entries, record):
            e_bit, e_k = entries

            def body(st):
                (bit_pos, k, done, over, err_bit, ends, boffs, ndata,
                 nblk, steps) = st
                byte = jnp.clip(bit_pos >> 3, 0, n - 1)
                wW = win[byte]
                w = tuple(wW[:, i] for i in range(W))
                off0 = (bit_pos & 7).astype(jnp.int32)
                off = off0
                base = (byte << 3).astype(jnp.int32)
                emits = []
                for _ in range(k1):
                    active = (~done) & (off <= off_lim)
                    consume, new_k, blk_done, skips, bad, _ln, _sym = (
                        sym_step(w, off, k, active)
                    )
                    app = active & ~bad
                    fin = app & blk_done
                    if record:
                        emits.append((
                            jnp.clip(ndata, 0, mbc - 1),
                            jnp.where(fin & (ndata < mbc),
                                      base + off + consume, 0),
                            jnp.where(fin & (ndata < mbc), nblk, 0),
                        ))
                        over = over | (fin & (ndata >= mbc))
                    ndata = jnp.where(fin, ndata + 1, ndata)
                    nblk = jnp.where(fin, nblk + 1 + skips, nblk)
                    k = jnp.where(fin, ss, jnp.where(app, new_k, k))
                    off = jnp.where(app, off + consume, off)
                    err_bit = jnp.where(
                        bad, jnp.minimum(err_bit, base + off), err_bit
                    )
                    done = done | (base + off >= chunk_end) | bad
                bit_pos = bit_pos - off0 + off
                if record:
                    arb = jnp.arange(mbc)[None, :]
                    ends = ends + sum(
                        jnp.where(ci[:, None] == arb, ev[:, None], 0)
                        for ci, ev, _ in emits
                    )
                    boffs = boffs + sum(
                        jnp.where(ci[:, None] == arb, bv[:, None], 0)
                        for ci, _, bv in emits
                    )
                return (bit_pos, k, done, over, err_bit, ends, boffs,
                        ndata, nblk, steps + 1)

            def cond(st):
                return (jnp.sum(st[2].astype(jnp.int32)) < L) & (
                    st[9] < inner_cap
                )

            shape1 = (L, mbc if record else 1)
            return jax.lax.while_loop(
                cond,
                body,
                (
                    e_bit,
                    e_k,
                    e_bit >= chunk_end,
                    jnp.zeros(L, bool),
                    jnp.full(L, 2**30, jnp.int32),
                    jnp.zeros(shape1, jnp.int32),
                    jnp.zeros(shape1, jnp.int32),
                    jnp.zeros(L, jnp.int32),
                    jnp.zeros(L, jnp.int32),
                    jnp.int32(0),
                ),
            )

        guess = (chunk_start, jnp.full(L, ss, jnp.int32))

        def shift(exits):
            bit, k = exits
            bit2 = bit.reshape(B, F)
            k2_ = k.reshape(B, F)
            return (
                jnp.concatenate([img_start[:, None], bit2[:, :-1]], 1).reshape(L),
                jnp.concatenate(
                    [jnp.full((B, 1), ss, jnp.int32), k2_[:, :-1]], 1
                ).reshape(L),
            )

        def sync_round(st):
            entries, _c, rounds = st
            sc = scan_chunks(entries, record=False)
            new_entries = shift((sc[0], sc[1]))
            chg = jnp.zeros((), bool)
            for a, bb in zip(new_entries, entries):
                chg = chg | jnp.any(a != bb)
            return (new_entries, chg, rounds + 1)

        st = (guess, jnp.ones((), bool), jnp.int32(0))
        st = jax.lax.while_loop(
            lambda s: s[1] & (s[2] < rounds_cap), sync_round, st
        )
        sc = scan_chunks(st[0], record=True)
        over, err_bit = sc[3], sc[4]
        ends_chunk, boffs_chunk = sc[5], sc[6]  # [L, mbc]
        ndata, nblk_adv = sc[7], sc[8]  # [L]

        # block index base per chunk: exclusive cumsum of block advances
        nblk_img = nblk_adv.reshape(B, F)
        blk_base = jnp.cumsum(nblk_img, axis=1) - nblk_img  # [B, F]
        ndata_img = ndata.reshape(B, F)
        data_base = jnp.cumsum(ndata_img, axis=1) - ndata_img
        total_data = jnp.sum(ndata_img, axis=1)  # [B]
        total_blk = jnp.sum(nblk_img, axis=1)
        # all valid blocks must be covered (data or eob-skip); the tail
        # may overshoot into padding
        total_ok = jnp.all(total_blk >= nvalid)
        err_ok = jnp.all(err_bit >= img_end[lane_img] - 16)

        # global data-block arrays [B, DMAX] with DMAX = nvalid cap
        gd = jnp.arange(nvalid)

        def per_image(dbase_b, ends_b, boffs_b, bbase_b):
            i_of = (
                jnp.searchsorted(dbase_b, gd, side="right") - 1
            ).astype(jnp.int32)
            i_of = jnp.clip(i_of, 0, F - 1)
            j_of = gd - dbase_b[i_of]
            rows = jnp.clip(i_of * mbc + j_of, 0, F * mbc - 1)
            ends_g = ends_b.reshape(F * mbc)[rows]
            gidx_g = boffs_b.reshape(F * mbc)[rows] + bbase_b[i_of]
            return ends_g, gidx_g

        ends_g, gidx_g = jax.vmap(per_image)(
            data_base, ends_chunk.reshape(B, F, mbc),
            boffs_chunk.reshape(B, F, mbc), blk_base,
        )  # [B, nvalid] each; rows past total_data are garbage

        # data-block start = previous data block's end (skipped blocks
        # consume nothing); first data block starts at img_start
        starts_g = jnp.concatenate(
            [img_start[:, None], ends_g[:, :-1]], axis=1
        )
        # real data blocks: within this image's data count AND inside the
        # valid grid (data blocks past nvalid are artifacts of decoding
        # into the encoder's padding bits — dropped, like the baseline
        # sync decoder's tail rule)
        d_valid = (gd[None, :] < total_data[:, None]) & (gidx_g < nvalid)

        # scatter data-block starts onto valid-block lanes
        flat_g = jnp.clip(gidx_g, 0, nvalid - 1) + nvalid * jnp.arange(B)[:, None]
        # pad rows index past the buffer and are dropped: a shared
        # in-bounds slack slot would serialize the scatter on one address
        flat_g = jnp.where(d_valid, flat_g, L2 + 1)
        starts_lane = (
            jnp.zeros(L2 + 1, jnp.int32)
            .at[flat_g.reshape(-1)]
            .set(starts_g.reshape(-1), mode="drop")[:L2]
        )
        ends_lane = (
            jnp.zeros(L2 + 1, jnp.int32)
            .at[flat_g.reshape(-1)]
            .set(ends_g.reshape(-1), mode="drop")[:L2]
        )
        has_data = (
            jnp.zeros(L2 + 1, bool)
            .at[flat_g.reshape(-1)]
            .set(True, mode="drop")[:L2]
        )

        # ---------------- value pass: one lane per valid block
        invT = jnp.asarray(invT_np)
        body2, cond2 = _make_ac_value_body(
            jax, jnp, win, n, W, sym_step, k2, se, invT, off_lim, L2
        )

        st2 = jax.lax.while_loop(
            cond2,
            body2,
            (
                starts_lane,
                jnp.zeros((64, L2), jnp.int32),
                jnp.full(L2, ss, jnp.int32),
                ~has_data,
                jnp.zeros(L2, bool),
                jnp.int32(0),
            ),
        )
        curT = st2[1]
        agree = (st2[0] == ends_lane) | ~has_data
        ok = (
            jnp.all(sc[2])
            & ~jnp.any(over)
            & total_ok
            & err_ok
            & jnp.all(st2[3])
            & ~jnp.any(st2[4])
            & jnp.all(agree)
        )
        return curT, ok

    if _raw:
        return decode
    import jax

    return jax.jit(decode)


def build_dc_first_value_fn(
    *, batch: int, nblk: int, cap: int, cmp: CmpTables,
    tid_of_slot: tuple, W: int = None, _raw: bool = False,
):
    """DC-first VALUE pass fed by the host C++ index pass
    (runtime.zpix_prog_dc_first_index) — the round-5 host/device split
    for progressive first scans.

    Every block is exactly ONE DC symbol + extend bits
    (/root/reference/src/jpeg/decoder.zig:1366-1376), so with exact
    per-block start offsets this pass has NO loop at all: one fully
    parallel compare-sum Huffman decode + receive/extend across all
    B*nblk lanes.  Verification: every lane's end bit must equal the
    host walk's end offset (``agree``), which re-derives the serial walk
    bit-for-bit.

    Input: packed [cap + 8*L] (stream ++ starts i32 ++ ends i32,
    absolute bit offsets into the stacked stream).  Returns
    (diffs [B, nblk] int32 raw DC diffs, ok).
    """
    import jax
    import jax.numpy as jnp

    from .device_entropy import _DEF_W

    L = batch * nblk
    W = W if W is not None else _DEF_W
    bpm = len(tid_of_slot)

    def decode(packed):
        stream = packed[:cap]

        def le32(off):
            pb = packed[off : off + 4 * L].reshape(L, 4).astype(jnp.int32)
            return (pb[:, 0] | (pb[:, 1] << 8) | (pb[:, 2] << 16)
                    | (pb[:, 3] << 24))

        starts = le32(cap)
        ends_expect = le32(cap + 4 * L)
        win, n = _window(jnp, stream, W)
        decode_sym = _make_sym_decoder(jnp, cmp)
        byte = jnp.clip(starts >> 3, 0, n - 1)
        wW = win[byte]
        w = tuple(wW[:, i] for i in range(W))
        off = (starts & 7).astype(jnp.int32)
        look16 = _bits_at(jnp, w, off, jnp.int32(16)).astype(jnp.int32)
        if bpm == 1:
            mt = [
                True if t == tid_of_slot[0] else None
                for t in range(cmp.ntab)
            ]
        else:
            slot = (jnp.arange(L) % bpm).astype(jnp.int32)
            tid = _select_by_index(jnp, slot, tid_of_slot)
            mt = [tid == t for t in range(cmp.ntab)]
        ln_sel, sym, bad = decode_sym(look16, mt)
        bad = bad | (sym > 16)  # decoder.py:548-551
        diff = _receive_extend(jnp, w, off + ln_sel, sym)
        end = starts + ln_sel + sym
        ok = ~jnp.any(bad) & jnp.all(end == ends_expect)
        return diff.reshape(batch, nblk), ok

    if _raw:
        return decode
    return jax.jit(decode)


def build_ac_first_value_fn(
    *, batch: int, nvalid: int, cap: int, cmp: CmpTables, ss: int,
    se: int, k2: int = None, W: int = None, _raw: bool = False,
):
    """AC-first VALUE pass fed by the host C++ index pass
    (runtime.zpix_prog_ac_first_index).

    One lane per VALID block; lanes whose block is EOB-covered
    (hasdata=0) idle.  The loop body is the same per-block spectral
    decode as the speculative path's value pass (_make_ac_value_body) —
    only the offsets' provenance changes, so the ``agree`` check (lane
    end == host end) re-derives the host walk bit-for-bit.

    Input: packed [cap + 12*L] (stream ++ starts i32 ++ ends i32 ++
    hasdata i32).  Returns (curT [64, B*nvalid] int32 natural-order
    values — << Al applied by the caller, ok).
    """
    import jax
    import jax.numpy as jnp

    from .device_entropy import _DEF_K, _DEF_W

    L2 = batch * nvalid
    k2 = k2 if k2 is not None else _DEF_K
    W = W if W is not None else _DEF_W
    off_lim = 32 * W - 48
    mt_one = [True if t == 0 else None for t in range(cmp.ntab)]

    inv = np.zeros(64, np.int64)
    inv[UNZIG] = np.arange(64)
    invT_np = inv[:, None]

    def decode(packed):
        stream = packed[:cap]

        def le32(off):
            pb = packed[off : off + 4 * L2].reshape(L2, 4).astype(jnp.int32)
            return (pb[:, 0] | (pb[:, 1] << 8) | (pb[:, 2] << 16)
                    | (pb[:, 3] << 24))

        starts = le32(cap)
        ends_expect = le32(cap + 4 * L2)
        has_data = le32(cap + 8 * L2) > 0
        win, n = _window(jnp, stream, W)
        decode_sym = _make_sym_decoder(jnp, cmp)
        sym_step = _make_ac_sym_step(jnp, decode_sym, mt_one, se)
        invT = jnp.asarray(invT_np)
        body2, cond2 = _make_ac_value_body(
            jax, jnp, win, n, W, sym_step, k2, se, invT, off_lim, L2
        )
        st2 = jax.lax.while_loop(
            cond2,
            body2,
            (
                starts,
                jnp.zeros((64, L2), jnp.int32),
                jnp.full(L2, ss, jnp.int32),
                ~has_data,
                jnp.zeros(L2, bool),
                jnp.int32(0),
            ),
        )
        agree = (st2[0] == ends_expect) | ~has_data
        ok = jnp.all(st2[3]) & ~jnp.any(st2[4]) & jnp.all(agree)
        return st2[1], ok

    if _raw:
        return decode
    return jax.jit(decode)


def build_ac_refine_fn(
    *, batch: int, nvalid: int, cap: int, cmp: CmpTables, ss: int, se: int,
    al: int, k_pos: int = None, W: int = None, _raw: bool = False,
):
    """AC refinement VALUE pass (Ss>0, Ah>0): one lane per valid block.

    The host C++ INDEX pass (runtime.zpix_prog_refine_index) supplies
    every block's exact entry bit offset and whether an EOB run covers
    it at entry, so each lane decodes its own block independently — the
    speculation-free split designed in the module docstring (AC
    refinement cannot self-synchronize).  Lanes walk zigzag positions
    ss..se with the reference's gating (refine_block semantics,
    decoder.zig:1459-1549): an existing nonzero reads one correction
    bit; a zero position counts down the current symbol's run and then
    receives the pending +-1<<Al coefficient; an EOB symbol switches
    the lane to corrections-only for the band tail.

    Verification: refinement blocks are bit-contiguous (EOB-covered
    blocks still consume their correction bits), so every lane must end
    exactly at the host-computed next-block entry offset.

    Input is ONE packed buffer [cap + 12 * L] (stream ++ starts i32 ++
    ends i32 ++ eob-entry i32, all absolute bit offsets into the
    stream) plus the current store rows curT [64, L] int32 natural
    order; returns (deltaT [64, L] int32 natural order, ok).
    """
    import jax
    import jax.numpy as jnp

    from .device_entropy import _DEF_K, _DEF_W

    L = batch * nvalid
    K = k_pos if k_pos is not None else _DEF_K
    W = W if W is not None else _DEF_W
    # worst-case reads per position iteration: 16 (symbol look) + 14
    # (EOB extra) + 1 (sign) + 1 (correction) — all inside the window
    off_lim = 32 * W - 80
    delta = 1 << al
    mt_one = [True if t == 0 else None for t in range(cmp.ntab)]
    max_steps = (2 * 64) // max(K, 1) + 24

    inv = np.zeros(64, np.int64)
    inv[UNZIG] = np.arange(64)
    invT_np = inv[:, None]  # [64, 1]: natural row -> its zigzag position

    def decode(packed, curT):
        stream = packed[:cap]

        def le32(off):
            pb = packed[off : off + 4 * L].reshape(L, 4).astype(jnp.int32)
            return (pb[:, 0] | (pb[:, 1] << 8) | (pb[:, 2] << 16)
                    | (pb[:, 3] << 24))

        starts = le32(cap)
        ends_expect = le32(cap + 4 * L)
        eob_entry = le32(cap + 8 * L) > 0
        win, n = _window(jnp, stream, W)
        decode_sym = _make_sym_decoder(jnp, cmp)
        invT = jnp.asarray(invT_np)

        def body(st):
            (bit_pos, kz, nz, pending, need_sym, in_eob, done, err,
             deltaT, steps) = st
            byte = jnp.clip(bit_pos >> 3, 0, n - 1)
            wW = win[byte]
            w = tuple(wW[:, i] for i in range(W))
            off0 = (bit_pos & 7).astype(jnp.int32)
            off = off0
            emits = []
            for _ in range(K):
                active = (~done) & (off <= off_lim)
                # -- decode the next (run, size) symbol where needed
                want = active & need_sym & ~in_eob
                look16 = _bits_at(jnp, w, off, jnp.int32(16)).astype(jnp.int32)
                ln_sel, sym, badh = decode_sym(look16, mt_one)
                r = sym >> 4
                s = sym & 15
                bad = want & (badh | (s > 1))  # refinement size is 0 or 1
                is_eob = (s == 0) & (r < 15)
                sign = _bits_at(jnp, w, off + ln_sel, jnp.int32(1))
                consume = ln_sel + jnp.where(
                    s == 1, 1, jnp.where(is_eob, jnp.clip(r, 0, 14), 0)
                )  # EOB extra bits are length-only here (count is host-side)
                app_sym = want & ~bad
                off = jnp.where(app_sym, off + consume, off)
                nz = jnp.where(
                    app_sym,
                    jnp.where(s == 0, jnp.where(is_eob, 0, 15), r),
                    nz,
                )
                pending = jnp.where(
                    app_sym,
                    jnp.where(
                        s == 1, jnp.where(sign > 0, delta, -delta), 0
                    ),
                    pending,
                )
                in_eob = in_eob | (app_sym & is_eob)
                need_sym = need_sym & ~app_sym
                err = err | bad
                done = done | bad

                # -- process zigzag position kz (refine_non_zeroes step)
                proc = active & (~need_sym | in_eob) & (kz <= se) & ~done
                coef = jnp.sum(
                    jnp.where(invT == kz[None, :], curT, 0), axis=0
                )
                nzc = coef != 0
                corr = proc & nzc
                cb = _bits_at(jnp, w, off, jnp.int32(1))
                off = jnp.where(corr, off + 1, off)
                dcorr = jnp.where(
                    corr & (cb > 0),
                    jnp.where(coef > 0, delta, -delta),
                    0,
                )
                z_skip = proc & ~nzc & ~in_eob & (nz > 0)
                z_place = proc & ~nzc & ~in_eob & (nz == 0)
                nz = jnp.where(z_skip, nz - 1, nz)
                emits.append((
                    jnp.clip(kz, 0, 63),
                    dcorr + jnp.where(z_place, pending, 0),
                ))
                pending = jnp.where(z_place, 0, pending)
                need_sym = need_sym | z_place
                kz = jnp.where(proc, kz + 1, kz)
                done = done | (kz > se)
            deltaT = deltaT + sum(
                jnp.where(ek[None, :] == invT, ev[None, :], 0)
                for ek, ev in emits
            )
            bit_pos = bit_pos - off0 + off
            return (bit_pos, kz, nz, pending, need_sym, in_eob, done, err,
                    deltaT, steps + 1)

        def cond(st):
            return (jnp.sum(st[6].astype(jnp.int32)) < L) & (
                st[9] < max_steps
            )

        st = jax.lax.while_loop(
            cond,
            body,
            (
                starts,
                jnp.full(L, ss, jnp.int32),
                jnp.zeros(L, jnp.int32),
                jnp.zeros(L, jnp.int32),
                ~eob_entry,  # eob-covered entries go straight to the tail
                eob_entry,
                jnp.zeros(L, bool),
                jnp.zeros(L, bool),
                jnp.zeros((64, L), jnp.int32),
                jnp.int32(0),
            ),
        )
        agree = st[0] == ends_expect
        ok = jnp.all(st[6]) & ~jnp.any(st[7]) & jnp.all(agree)
        return st[8], ok

    if _raw:
        return decode
    import jax

    return jax.jit(decode)


# ------------------------------------------------------------ orchestration


class _TailScanDecoder:
    """Host decoder that SKIPS the first `skip` scans' entropy decode
    (they ran on the chip) and decodes only the tail, seeded with the
    device store — so the host does zero Huffman work for the on-chip
    prefix."""

    def __init__(self, data: bytes, skip: int, seed):
        from ..codecs.jpeg.decoder import Decoder

        outer = self

        class _D(Decoder):
            def __init__(self):
                super().__init__(data)
                self.collect_only = True
                self._scan_no = 0

            def process_sos(self, n: int) -> None:
                if self._scan_no < skip:
                    self._scan_no += 1
                    # consume the SOS header + entropy bytes to the next
                    # real marker (stuffed FF00 and RSTs are entropy data)
                    self.read_full(n)
                    d, p = self.data, self.pos
                    while p < len(d) - 1:
                        if (
                            d[p] == 0xFF
                            and d[p + 1] != 0x00
                            and d[p + 1] != 0xFF
                            and not (0xD0 <= d[p + 1] <= 0xD7)
                        ):
                            break
                        p += 1
                    self.pos = p
                    return
                if self._scan_no == skip and seed is not None:
                    h0, v0 = self.component[0].h, self.component[0].v
                    mxx = (self.width + 8 * h0 - 1) // (8 * h0)
                    myy = (self.height + 8 * v0 - 1) // (8 * v0)
                    if not self.img_allocated:
                        self._make_img(mxx, myy)
                    for c, arr in enumerate(seed):
                        if arr is None:
                            continue
                        self._ensure_coeff(c)
                        self.coeff[c][...] = arr
                    outer.seeded = True
                self._scan_no += 1
                super().process_sos(n)

        self.dec = _D()
        self.seeded = False

    def run(self):
        self.dec.decode_inner(False)
        return self.dec


class OnchipProgressiveDecoder:
    """Progressive JPEG batch with ON-CHIP first-scan entropy decode.

    decode(datas) -> (device gray/RGB array, ok device bool).  The
    device decodes every DC-first / AC-first / DC-refine scan of the
    shared scan script (the standard libjpeg script's entire spectral
    pass); only AC refinements run host-side, seeded by ONE store fetch.
    ok=False (failed speculative verification, unsupported script) ->
    decode_verified falls back to the host decoder.
    """

    def __init__(self, *, chunk_bytes: int = 64, k1: int | None = None,
                 k2: int | None = None, W: int | None = None,
                 impl: str | None = None, max_batch: int | None = None):
        import os as _os

        self.chunk_bytes = chunk_bytes
        self.k1, self.k2, self.W = k1, k2, W
        # "hostindex" (default): C++ lengths-only index passes feed small
        # per-scan device value passes — no speculative fixed points.
        # "spec": the device-resident speculative-chunk path (also taken
        # when an index pass rejects a stream).  "hostindex" needs the
        # native runtime and raises without it.
        self.impl = impl or _os.environ.get("ZPIX_PROG_IMPL", "hostindex")
        # decode() splits larger batches into equal-shaped sub-batches
        # that reuse one compiled program.
        self.max_batch = max_batch if max_batch is not None else int(
            _os.environ.get("ZPIX_PROG_MAX_BATCH", "16")
        )
        self._fns: dict = {}
        self._recon_fns: dict = {}
        self._geom: dict = {}
        self._pool_ = None

    @property
    def _pool(self):
        """Shared worker pool for per-image host passes (a fresh
        ThreadPoolExecutor per scan cost ~ms in spawn/join x10+ scans
        per prep)."""
        import os as _os
        from concurrent.futures import ThreadPoolExecutor

        if self._pool_ is None:
            self._pool_ = ThreadPoolExecutor(
                max_workers=_os.cpu_count() or 2
            )
        return self._pool_

    # ---------------- host-side geometry helpers

    def _valid_idx(self, plan: ProgPlan, c: int) -> np.ndarray:
        """Raster indices of the component's VALID blocks
        (decoder.py:525-529: 8px origin inside the image)."""
        hc, vc = plan.hv[c]
        bw, bh = plan.mxx * hc, plan.myy * vc
        bx = np.arange(bw) * 8 < plan.width
        by = np.arange(bh) * 8 < plan.height
        mask = by[:, None] & bx[None, :]
        return np.flatnonzero(mask.reshape(-1)).astype(np.int32)

    def _mcu_grid_idx(self, plan: ProgPlan, scan_comps: tuple) -> list:
        """Per scan component: flat grid index of each of its blocks in
        MCU-interleaved stream order (decoder.py:520-523).  Vectorized +
        cached: prep() runs per batch and the scalar triple loop cost
        ~ms at 4k MCUs."""
        key = ("grid", plan.mxx, plan.myy, plan.hv, tuple(scan_comps))
        hit = self._geom.get(key)
        if hit is not None:
            return hit
        out = []
        for c in scan_comps:
            hc, vc = plan.hv[c]
            bw = plan.mxx * hc
            my = np.arange(plan.myy)[:, None, None]
            mx = np.arange(plan.mxx)[None, :, None]
            j = np.arange(hc * vc)[None, None, :]
            idxs = (
                (vc * my + j // hc) * bw + hc * mx + j % hc
            ).reshape(-1).astype(np.int64)
            out.append(idxs)
        self._geom[key] = out
        return out

    def _stack_streams(self, streams: list) -> tuple:
        """Concatenate per-image scan streams (8-aligned) + pad."""
        offs, total = [], 0
        for s in streams:
            offs.append(total)
            total += (len(s) + 7) // 8 * 8
        # 64 KiB buckets (NOT pow2): cap is upload bytes — pow2 shipped
        # up to 2x zeros per scan row
        cap = max(4096, -(-(total + 64) // 65536) * 65536)
        flat = np.zeros(cap, np.uint8)
        for s, o in zip(streams, offs):
            flat[o : o + len(s)] = s
        starts = np.array([o * 8 for o in offs], np.int64)
        ends = np.array(
            [(o + len(s)) * 8 for o, s in zip(offs, streams)], np.int64
        )
        n_chunks = (max(len(s) for s in streams) + self.chunk_bytes - 1) \
            // self.chunk_bytes
        n_chunks = max(1, (n_chunks + 7) // 8 * 8)
        return flat, starts, ends, n_chunks

    # ---------------- per-scan device dispatch

    def _run_dc_first(self, plans, s: int, state, jnp):
        p0 = plans[0]
        sc: ScanInfo = p0.scans[s]
        interleaved = len(sc.comps) > 1
        order = []
        for td in sc.td:
            if (0, td) not in order:
                order.append((0, td))
        cmp = CmpTables([sc.huffs[kk] for kk in order])
        tid_of_comp = {c: order.index((0, sc.td[i]))
                       for i, c in enumerate(sc.comps)}
        if interleaved:
            tid_of_slot = []
            for c in sc.comps:
                tid_of_slot += [tid_of_comp[c]] * (
                    p0.hv[c][0] * p0.hv[c][1]
                )
            nblk = p0.mxx * p0.myy * len(tid_of_slot)
            grid_maps = self._mcu_grid_idx(p0, sc.comps)
        else:
            c = sc.comps[0]
            tid_of_slot = [tid_of_comp[c]]
            vidx = self._valid_idx(p0, c)
            nblk = len(vidx)
        flat, starts, ends, F = self._stack_streams(
            [pl.scans[s].stream for pl in plans]
        )
        key = ("dc", self._cur_key, s, len(plans), F, flat.shape[0])
        fn = self._fns.get(key)
        if fn is None:
            fn = build_dc_first_fn(
                batch=len(plans), n_chunks=F, chunk_bytes=self.chunk_bytes,
                cmp=cmp, tid_of_slot=tuple(tid_of_slot), nblk_total=nblk,
                k1=self.k1, W=self.W,
            )
            self._fns[key] = fn
        import jax as _jax

        diffs, ok = fn(
            _jax.device_put(flat), _jax.device_put(starts),
            _jax.device_put(ends),
        )
        B = len(plans)
        al = sc.al
        if interleaved:
            bpm = len(tid_of_slot)
            d3 = diffs.reshape(B, p0.mxx * p0.myy, bpm)
            s0 = 0
            for i, c in enumerate(sc.comps):
                nb = p0.hv[c][0] * p0.hv[c][1]
                seq = d3[:, :, s0 : s0 + nb].reshape(B, -1)
                dc = jnp.cumsum(seq, axis=1) << al  # decoder.py:552-554
                pos = jnp.asarray(grid_maps[i] * 64)
                state[c] = state[c].at[:, pos].set(dc)
                s0 += nb
        else:
            c = sc.comps[0]
            dc = jnp.cumsum(diffs, axis=1) << al
            pos = jnp.asarray(vidx.astype(np.int64) * 64)
            state[c] = state[c].at[:, pos].set(dc)
        return ok

    def _run_ac_first(self, plans, s: int, state, jnp):
        import jax as _jax

        p0 = plans[0]
        sc: ScanInfo = p0.scans[s]
        c = sc.comps[0]
        cmp = CmpTables([sc.huffs[(1, sc.ta[0])]])
        vidx = self._valid_idx(p0, c)
        nvalid = len(vidx)
        flat, starts, ends, F = self._stack_streams(
            [pl.scans[s].stream for pl in plans]
        )
        key = ("ac", self._cur_key, s, len(plans), F, flat.shape[0])
        fn = self._fns.get(key)
        if fn is None:
            fn = build_ac_first_fn(
                batch=len(plans), n_chunks=F, chunk_bytes=self.chunk_bytes,
                cmp=cmp, tid=0, ss=sc.ss, se=sc.se, nvalid=nvalid,
                k1=self.k1, k2=self.k2, W=self.W,
            )
            self._fns[key] = fn
        curT, ok = fn(
            _jax.device_put(flat), _jax.device_put(starts),
            _jax.device_put(ends),
        )
        B = len(plans)
        hc, vc = p0.hv[c]
        nblk_c = p0.mxx * hc * p0.myy * vc
        # [64, B*nvalid] -> [B, nvalid, 64] natural order, << Al
        vals = jnp.transpose(curT.reshape(64, B, nvalid), (1, 2, 0)) << sc.al
        contrib = (
            jnp.zeros((B, nblk_c, 64), jnp.int32)
            .at[:, jnp.asarray(vidx)]
            .set(vals)
        )
        state[c] = state[c] + contrib.reshape(B, nblk_c * 64)
        return ok

    # ---------------- host-index mode (round 5): C++ index passes for
    # EVERY scan up front, ONE super upload, small per-scan value passes

    def _dc_scan_geom(self, p0, sc):
        """(cmp, tid_of_slot, nblk, grid_maps-or-vidx) for a DC scan."""
        interleaved = len(sc.comps) > 1
        order = []
        for td in sc.td:
            if (0, td) not in order:
                order.append((0, td))
        cmp = CmpTables([sc.huffs[kk] for kk in order])
        tid_of_comp = {c: order.index((0, sc.td[i]))
                       for i, c in enumerate(sc.comps)}
        if interleaved:
            tid_of_slot = []
            for c in sc.comps:
                tid_of_slot += [tid_of_comp[c]] * (
                    p0.hv[c][0] * p0.hv[c][1]
                )
            nblk = p0.mxx * p0.myy * len(tid_of_slot)
            pos = self._mcu_grid_idx(p0, sc.comps)
        else:
            c = sc.comps[0]
            tid_of_slot = [tid_of_comp[c]]
            pos = self._valid_idx(p0, c)
            nblk = len(pos)
        return cmp, tuple(tid_of_slot), nblk, pos, order

    def _prep_dc_first(self, plans, s: int, lib):
        """Host C++ DC-first index pass -> packed buffer + meta, or
        None on an index error (caller falls back)."""
        import ctypes

        from .. import runtime

        p0 = plans[0]
        sc: ScanInfo = p0.scans[s]
        cmp, tid_of_slot, nblk, pos, order = self._dc_scan_geom(p0, sc)
        B = len(plans)
        huff_arr = (runtime.HuffTableC * len(order))()
        for i, kk in enumerate(order):
            tab = sc.huffs[kk]
            ct = huff_arr[i]
            ct.min_codes[:] = tab.min_codes
            ct.max_codes[:] = tab.max_codes
            ct.vals_indices[:] = tab.vals_indices
            ct.vals[:] = tab.vals
            ct.num_codes = tab.num_codes
        tids = np.asarray(tid_of_slot, np.int32)
        streams = [np.ascontiguousarray(pl.scans[s].stream) for pl in plans]
        padded = [
            np.ascontiguousarray(np.concatenate([st, np.zeros(8, np.uint8)]))
            for st in streams
        ]
        ends = np.empty((B, nblk), np.int32)

        def one(b):
            endb = ctypes.c_int64(0)
            return lib.zpix_prog_dc_first_index(
                padded[b].ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                len(streams[b]), huff_arr,
                tids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                len(tid_of_slot), nblk,
                ends[b].ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                ctypes.byref(endb),
            )

        if any(rc != 0 for rc in self._pool.map(one, range(B))):
            return None
        starts = np.empty((B, nblk), np.int32)
        starts[:, 0] = 0
        starts[:, 1:] = ends[:, :-1]
        flat, bstarts, _be, _F = self._stack_streams(streams)
        cap = int(flat.shape[0])
        b32 = bstarts[:, None].astype(np.int32)
        packed = np.concatenate([
            flat, (starts + b32).astype("<i4").reshape(-1).view(np.uint8),
            (ends + b32).astype("<i4").reshape(-1).view(np.uint8),
        ])
        return dict(kind="dc", packed=packed, cap=cap, nblk=nblk,
                    cmp=cmp, tid_of_slot=tid_of_slot, pos=pos,
                    comps=sc.comps, al=sc.al,
                    interleaved=len(sc.comps) > 1)

    def _prep_ac_first(self, plans, s: int, masks, lib):
        """Host C++ AC-first index pass; also evolves the host-side
        nonzero masks so later refinement index passes need NO device
        store fetch.  Returns packed buffer + meta, or None."""
        import ctypes

        from .. import runtime

        p0 = plans[0]
        sc: ScanInfo = p0.scans[s]
        c = sc.comps[0]
        vidx = self._valid_idx(p0, c)
        nvalid = len(vidx)
        B = len(plans)
        hc, vc = p0.hv[c]
        nblk_c = p0.mxx * hc * p0.myy * vc
        for b in range(B):
            if (b, c) not in masks:
                masks[(b, c)] = np.zeros((nvalid, 64), np.uint8)
        h = sc.huffs[(1, sc.ta[0])]
        tab = runtime.HuffTableC()
        tab.min_codes[:] = h.min_codes
        tab.max_codes[:] = h.max_codes
        tab.vals_indices[:] = h.vals_indices
        tab.vals[:] = h.vals
        tab.num_codes = h.num_codes
        streams = [np.ascontiguousarray(pl.scans[s].stream) for pl in plans]
        padded = [
            np.ascontiguousarray(np.concatenate([st, np.zeros(8, np.uint8)]))
            for st in streams
        ]
        starts = np.empty((B, nvalid), np.int32)
        ends = np.empty((B, nvalid), np.int32)
        hasdata = np.empty((B, nvalid), np.uint8)

        def one(b):
            endb = ctypes.c_int64(0)
            return lib.zpix_prog_ac_first_index(
                padded[b].ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                len(streams[b]), ctypes.byref(tab), sc.ss, sc.se, nvalid,
                starts[b].ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                ends[b].ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                hasdata[b].ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                masks[(b, c)].ctypes.data_as(
                    ctypes.POINTER(ctypes.c_uint8)
                ),
                ctypes.byref(endb),
            )

        if any(rc != 0 for rc in self._pool.map(one, range(B))):
            return None
        flat, bstarts, _be, _F = self._stack_streams(streams)
        cap = int(flat.shape[0])
        b32 = bstarts[:, None].astype(np.int32)
        packed = np.concatenate([
            flat, (starts + b32).astype("<i4").reshape(-1).view(np.uint8),
            (ends + b32).astype("<i4").reshape(-1).view(np.uint8),
            hasdata.astype("<i4").reshape(-1).view(np.uint8),
        ])
        return dict(kind="ac", packed=packed, cap=cap, c=c, vidx=vidx,
                    nvalid=nvalid, huff=h, nblk_c=nblk_c,
                    ss=sc.ss, se=sc.se, al=sc.al)

    def _prep_hostindex(self, plans):
        """Walk EVERY scan's host index pass in script order (masks and
        EOB-run state evolve host-side, in order), stack all packed
        buffers.  Returns (preps {si: (row_idx-or-None, meta-or-None)},
        sup [n_rows, capmax] np.uint8), or None when an index pass rejects
        a stream (-> speculative path).  Raises without the native
        runtime."""
        from .. import runtime

        lib = runtime.get_lib()
        if lib is None:
            raise RuntimeError(
                "jpeg: the progressive hostindex decode needs the native "
                "runtime (zpix/runtime), which did not load"
            )
        p0 = plans[0]
        masks: dict = {}
        eob_runs = [0] * len(plans)
        preps: dict = {}
        rows: list = []
        for si, sc in enumerate(p0.scans):
            kind = sc.kind
            if kind in ("ac_first", "ac_refine") and len(sc.comps) != 1:
                return None  # malformed (AC scans are single-component)
            if kind == "dc_first":
                meta = self._prep_dc_first(plans, si, lib)
            elif kind == "ac_first":
                meta = self._prep_ac_first(plans, si, masks, lib)
            elif kind == "ac_refine":
                meta = self._prep_ac_refine(
                    plans, si, masks, eob_runs, None
                )
                if meta is not None:
                    meta["kind"] = "acr"
            else:  # dc_refine: raw bit rows, device unpack
                meta = self._prep_dc_refine_rows(plans, si)
            if meta is None:
                return None
            preps[si] = (len(rows), meta)
            rows.append(meta["packed"])
        # final row: per-image quant tables (LE i32), so the fused
        # program needs exactly ONE upload
        q = np.stack(
            [np.stack([pl.quants[c] for pl in plans])
             for c in range(p0.ncomp)]
        ).astype("<i4")
        rows.append(q.reshape(-1).view(np.uint8))
        # FLAT concatenation with static per-row offsets (not a padded
        # [rows, capmax] matrix: the biggest scan's row would size every
        # row — measured 11.5 MB vs ~4 flat at 16x512², r5_prog1/2) —
        # the fused program slices each row at its baked offset.  Total
        # pads to a 64 KiB multiple so same-script batches share one
        # compiled program.
        offs = []
        off = 0
        for r in rows:
            offs.append(off)
            off += int(r.shape[0])
        total = -(-off // 65536) * 65536
        sup = np.zeros(total, np.uint8)
        for r, o in zip(rows, offs):
            sup[o : o + r.shape[0]] = r
        for si in preps:
            ri, meta = preps[si]
            meta["off"] = offs[ri]
        return preps, sup, offs[-1]

    def _make_update(self, si, row_idx, meta, B, jnp):
        """Per-scan pure update closure `update(sup, state) -> (state,
        ok)` on the FULL component-store list, reading the scan's packed
        buffer out of the super-upload row.  These compose into ONE
        fused jit program per scan script (_build_fused): one dispatch
        per batch instead of one per scan."""
        kind = meta["kind"]
        al = meta["al"]
        off = meta["off"]  # static offset into the flat super buffer
        comps = meta["comps"] if kind in ("dc", "dcr") else (meta["c"],)

        if kind == "dc":
            nblk = meta["nblk"]
            cap = meta["cap"]
            total_len = cap + 8 * B * nblk
            kern = build_dc_first_value_fn(
                batch=B, nblk=nblk, cap=cap, cmp=meta["cmp"],
                tid_of_slot=meta["tid_of_slot"], W=self.W, _raw=True,
            )
            if meta["interleaved"]:
                hv = self._cur_hv
                grid_maps = meta["pos"]
                nbs = [hv[c][0] * hv[c][1] for c in comps]
                bpm = sum(nbs)

                def update(sup, state):
                    pk = sup[off : off + total_len]
                    diffs, ok = kern(pk)
                    d3 = diffs.reshape(B, nblk // bpm, bpm)
                    out = list(state)
                    s0 = 0
                    for i, c in enumerate(comps):
                        seq = d3[:, :, s0 : s0 + nbs[i]].reshape(B, -1)
                        dc = jnp.cumsum(seq, axis=1) << al
                        pos = jnp.asarray(grid_maps[i] * 64)
                        out[c] = state[c].at[:, pos].set(dc)
                        s0 += nbs[i]
                    return out, ok

                return update
            vidx = meta["pos"]
            pos_np = vidx.astype(np.int64) * 64
            c0 = comps[0]

            def update(sup, state):
                pk = sup[off : off + total_len]
                diffs, ok = kern(pk)
                dc = jnp.cumsum(diffs, axis=1) << al
                out = list(state)
                out[c0] = state[c0].at[:, jnp.asarray(pos_np)].set(dc)
                return out, ok

            return update

        if kind == "ac":
            c = meta["c"]
            nvalid = meta["nvalid"]
            nblk_c = meta["nblk_c"]
            cap = meta["cap"]
            total_len = cap + 12 * B * nvalid
            kern = build_ac_first_value_fn(
                batch=B, nvalid=nvalid, cap=cap,
                cmp=CmpTables([meta["huff"]]),
                ss=meta["ss"], se=meta["se"],
                k2=self.k2, W=self.W, _raw=True,
            )
            vj_np = meta["vidx"].astype(np.int64)

            def update(sup, state):
                pk = sup[off : off + total_len]
                curT, ok = kern(pk)
                vals = jnp.transpose(
                    curT.reshape(64, B, nvalid), (1, 2, 0)
                ) << al
                new = state[c].reshape(B, nblk_c, 64).at[
                    :, jnp.asarray(vj_np)
                ].add(vals)
                out = list(state)
                out[c] = new.reshape(B, nblk_c * 64)
                return out, ok

            return update

        if kind == "acr":
            c = meta["c"]
            nvalid = meta["nvalid"]
            nblk_c = meta["nblk_c"]
            cap = meta["cap"]
            total_len = cap + 12 * B * nvalid
            kern = build_ac_refine_fn(
                batch=B, nvalid=nvalid, cap=cap,
                cmp=CmpTables([meta["huff"]]),
                ss=meta["ss"], se=meta["se"], al=meta["al"],
                k_pos=self.k2, W=self.W, _raw=True,
            )
            vj_np = meta["vidx"].astype(np.int64)

            def update(sup, state):
                pk = sup[off : off + total_len]
                vj = jnp.asarray(vj_np)
                cur = state[c].reshape(B, nblk_c, 64)[:, vj]
                curT = jnp.transpose(cur, (2, 0, 1)).reshape(64, -1)
                deltaT, ok = kern(pk, curT)
                d_n = jnp.transpose(
                    deltaT.reshape(64, B, nvalid), (1, 2, 0)
                )
                new = state[c].reshape(B, nblk_c, 64).at[:, vj].add(d_n)
                out = list(state)
                out[c] = new.reshape(B, nblk_c * 64)
                return out, ok

            return update

        # kind == "dcr": one raw bit per block, unpacked on device
        rowlen = meta["rowlen"]
        nblk = meta["nblk"]
        delta_v = 1 << al
        hv = self._cur_hv

        def update(sup, state):
            rows = sup[off : off + B * rowlen].reshape(B, rowlen)
            bits = jnp.unpackbits(rows, axis=1)[:, :nblk]
            delta = jnp.int32(delta_v)
            out = list(state)
            if len(comps) > 1:
                grid_maps = meta["pos"]
                bl = [hv[c][0] * hv[c][1] for c in comps]
                bpm = sum(bl)
                b3 = bits.reshape(B, nblk // bpm, bpm)
                s0 = 0
                for i, c in enumerate(comps):
                    bseq = b3[:, :, s0 : s0 + bl[i]].reshape(B, -1)
                    pos = jnp.asarray(grid_maps[i] * 64)
                    cur = state[c][:, pos]
                    out[c] = state[c].at[:, pos].set(
                        jnp.where(bseq > 0, cur | delta, cur)
                    )
                    s0 += bl[i]
            else:
                c = comps[0]
                pos = jnp.asarray(meta["pos"].astype(np.int64) * 64)
                cur = state[c][:, pos]
                out[c] = state[c].at[:, pos].set(
                    jnp.where(bits > 0, cur | delta, cur)
                )
            return out, jnp.asarray(True)  # okh folds in host-side

        return update

    def _prep_dc_refine_rows(self, plans, s: int):
        """DC refinement host half: one raw bit per block, packed into a
        super-upload row (the device half unpacks + ORs 1<<Al)."""
        p0 = plans[0]
        sc: ScanInfo = p0.scans[s]
        B = len(plans)
        if len(sc.comps) > 1:
            pos = self._mcu_grid_idx(p0, sc.comps)
            bpm = sum(p0.hv[c][0] * p0.hv[c][1] for c in sc.comps)
            nblk = p0.mxx * p0.myy * bpm
        else:
            pos = self._valid_idx(p0, sc.comps[0])
            nblk = len(pos)
        nbytes = (nblk + 7) // 8
        rows = np.zeros((B, nbytes), np.uint8)
        okh = True
        for b, pl in enumerate(plans):
            st = pl.scans[s].stream
            if len(st) < nbytes:
                okh = False
                st = np.pad(st, (0, nbytes - len(st)))
            rows[b, :nbytes] = st[:nbytes]
        return dict(kind="dcr", packed=rows.reshape(-1),
                    rowlen=nbytes, nblk=nblk, comps=sc.comps,
                    al=sc.al, pos=pos, okh=okh)

    def _build_fused(self, preps, plans, B, capmax, q_off):
        """ONE jit program for the whole scan script: every scan's value
        pass + store update, then dequant+IDCT+color — a single device
        dispatch reading a single FLAT packed super upload (each row
        sliced at a baked static offset; the quants ride the tail)."""
        import jax
        import jax.numpy as jnp

        from .batch import _gray_graph, _ycbcr_graph

        # the update closures bake each scan's row offset and capacity
        # and the quant-row offset: all part of the program's identity
        layout = tuple(
            (si, meta.get("off"), meta.get("cap"))
            for si, (_ri, meta) in sorted(preps.items()) if meta is not None
        )
        key = ("fusedprog", self._cur_key, B, capmax, q_off, layout)
        fn = self._fns.get(key)
        if fn is not None:
            return fn
        p0 = plans[0]
        ncomp = p0.ncomp
        shapes = [
            (p0.myy * p0.hv[c][1], p0.mxx * p0.hv[c][0], 64)
            for c in range(ncomp)
        ]
        updates = [
            self._make_update(si, preps[si][0], preps[si][1], B, jnp)
            for si in sorted(preps)
        ]
        q_len = ncomp * B * 64 * 4

        def fused(sup):
            state = [
                jnp.zeros((B, int(np.prod(shapes[c]))), jnp.int32)
                for c in range(ncomp)
            ]
            ok = jnp.asarray(True)
            for upd in updates:
                state, oki = upd(sup, state)
                ok = ok & oki
            qb = sup[q_off : q_off + q_len].reshape(
                ncomp, B, 64, 4
            ).astype(jnp.int32)
            quants = [
                qb[c, :, :, 0] | (qb[c, :, :, 1] << 8)
                | (qb[c, :, :, 2] << 16) | (qb[c, :, :, 3] << 24)
                for c in range(ncomp)
            ]
            grids = [
                state[c].reshape((B,) + shapes[c]) for c in range(ncomp)
            ]
            if ncomp == 1:
                out = _gray_graph(
                    grids[0], quants[0], height=p0.height, width=p0.width
                )
            else:
                out = _ycbcr_graph(
                    grids[0], grids[1], grids[2], *quants,
                    height=p0.height, width=p0.width, ratio=p0.ratio,
                )
            return out, ok

        fn = jax.jit(fused)
        self._fns[key] = fn
        return fn

    def prep(self, datas: list[bytes]):
        """Host half of the host-index path: parse + C++ index walks +
        ONE packed super buffer (scan rows ++ quants row).  Returns a
        dict for run(), or None when an index pass rejects a stream
        (caller uses the speculative path)."""
        plans = [parse_progressive(d) for d in datas]
        self._check_batch(plans)
        hi = self._prep_hostindex(plans)
        if hi is None:
            return None
        preps, sup, q_off = hi
        okh = all(
            meta.get("okh", True)
            for _ri, meta in preps.values()
            if meta is not None
        )
        return dict(plans=plans, preps=preps, sup=sup, okh=okh,
                    q_off=q_off, key=self._cur_key)

    def run(self, pr, sup_dev=None):
        """Device half: ONE dispatch of the fused script program.
        sup_dev: optionally a pre-uploaded (staged) super buffer."""
        import jax

        plans = pr["plans"]
        B = len(plans)
        self._cur_key = pr["key"]
        self._cur_hv = plans[0].hv
        fused = self._build_fused(
            pr["preps"], plans, B, int(pr["sup"].shape[0]), pr["q_off"]
        )
        if sup_dev is None:
            sup_dev = jax.device_put(pr["sup"])
        out, okd = fused(sup_dev)
        return out, okd & pr["okh"]

    def _run_dc_refine(self, plans, s: int, state, jnp):
        import jax as _jax

        p0 = plans[0]
        sc: ScanInfo = p0.scans[s]
        B = len(plans)
        al = sc.al
        if len(sc.comps) > 1:
            grid_maps = self._mcu_grid_idx(p0, sc.comps)
            bpm = sum(p0.hv[c][0] * p0.hv[c][1] for c in sc.comps)
            nblk = p0.mxx * p0.myy * bpm
        else:
            c0 = sc.comps[0]
            vidx = self._valid_idx(p0, c0)
            nblk = len(vidx)
        nbytes = (nblk + 7) // 8
        rows = np.zeros((B, nbytes), np.uint8)
        okh = True
        for b, pl in enumerate(plans):
            st = pl.scans[s].stream
            if len(st) < nbytes:
                okh = False
                st = np.pad(st, (0, nbytes - len(st)))
            rows[b, :nbytes] = st[:nbytes]
        # one raw bit per block, MSB-first (decoder.py:199-205 bit reader)
        bits = jnp.unpackbits(_jax.device_put(rows), axis=1)[:, :nblk]
        delta = jnp.int32(1 << al)
        if len(sc.comps) > 1:
            # bits are in MCU-interleaved block order; slice per component
            s0 = 0
            bl = []
            for c in sc.comps:
                bl.append(p0.hv[c][0] * p0.hv[c][1])
            bpm = sum(bl)
            b3 = bits.reshape(B, p0.mxx * p0.myy, bpm)
            s0 = 0
            for i, c in enumerate(sc.comps):
                nb = bl[i]
                bseq = b3[:, :, s0 : s0 + nb].reshape(B, -1)
                pos = jnp.asarray(grid_maps[i] * 64)
                cur = state[c][:, pos]
                state[c] = state[c].at[:, pos].set(
                    jnp.where(bseq > 0, cur | delta, cur)
                )
                s0 += nb
        else:
            c = sc.comps[0]
            pos = jnp.asarray(vidx.astype(np.int64) * 64)
            cur = state[c][:, pos]
            state[c] = state[c].at[:, pos].set(
                jnp.where(bits > 0, cur | delta, cur)
            )
        import jax.numpy as _jnp

        return _jnp.asarray(okh)

    def _prep_ac_refine(self, plans, s: int, masks, eob_runs, seeds):
        """AC refinement scan, HOST half: C++ INDEX pass (bit offsets
        only) -> packed device buffer + static meta (device half:
        _apply_ac_refine).

        masks: {(b, c): [nvalid, 64] uint8 zigzag nonzero flags},
        maintained across refinement scans by the index passes
        themselves (a new +-1<<Al coefficient sets its flag); seeded
        lazily per component from the ONE store fetch (``seeds``).  In
        hostindex mode seeds=None: the AC-first index passes
        (zpix_prog_ac_first_index) already populated the masks
        host-side, so a component with no mask yet simply has no
        nonzero coefficients (all-zero seed, no device fetch at all).
        eob_runs: per-image EOB-run state carried across refinement
        scans (reference decoder state; zero entering the first
        refinement — well-formed first scans never leave a dangling
        run, which the round-3 host-tail path already assumed).

        Returns a meta dict (packed buffer + kernel statics), or None ->
        caller falls back to the host tail at this scan."""
        import ctypes

        from .. import runtime

        lib = runtime.get_lib()
        if lib is None:
            return None
        p0 = plans[0]
        sc: ScanInfo = p0.scans[s]
        c = sc.comps[0]
        vidx = self._valid_idx(p0, c)
        nvalid = len(vidx)
        B = len(plans)
        hc, vc = p0.hv[c]
        nblk_c = p0.mxx * hc * p0.myy * vc
        for b in range(B):  # lazy per-component mask seeding
            if (b, c) not in masks:
                if seeds is None:  # hostindex mode: no prior nonzeros
                    masks[(b, c)] = np.zeros((nvalid, 64), np.uint8)
                else:
                    arr = seeds[c][b].reshape(nblk_c, 64)[vidx]
                    masks[(b, c)] = np.ascontiguousarray(
                        (arr[:, UNZIG] != 0).astype(np.uint8)
                    )
        h = sc.huffs[(1, sc.ta[0])]
        tab = runtime.HuffTableC()
        tab.min_codes[:] = h.min_codes
        tab.max_codes[:] = h.max_codes
        tab.vals_indices[:] = h.vals_indices
        tab.vals[:] = h.vals
        tab.num_codes = h.num_codes
        streams = [np.ascontiguousarray(pl.scans[s].stream) for pl in plans]
        # the C++ walk reads 4-byte windows: pad >= 8 readable bytes
        padded = [
            np.ascontiguousarray(np.concatenate([st, np.zeros(8, np.uint8)]))
            for st in streams
        ]
        offs = np.empty((B, nvalid), np.int32)
        eobs = np.empty((B, nvalid), np.uint8)

        def one(b):
            st = padded[b]
            ero = ctypes.c_uint16(0)
            endb = ctypes.c_int64(0)
            rc = lib.zpix_prog_refine_index(
                st.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                len(streams[b]), ctypes.byref(tab),
                masks[(b, c)].ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                nvalid, sc.ss, sc.se, np.uint16(eob_runs[b]),
                offs[b].ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                eobs[b].ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                ctypes.byref(ero), ctypes.byref(endb),
            )
            return rc, b, ero.value, int(endb.value)

        res = list(self._pool.map(one, range(B)))
        endbs = [0] * B
        for rc, b, ero, endb in res:
            if rc != 0:
                return None
            eob_runs[b] = ero
            endbs[b] = endb
        ends = np.empty((B, nvalid), np.int32)
        ends[:, :-1] = offs[:, 1:]
        ends[:, -1] = endbs
        # packed form: stream ++ absolute starts ++ ends ++ eob flags.
        # The caller stacks EVERY refinement scan's packed buffer into
        # ONE device transfer.
        flat, bstarts, _bends, _F = self._stack_streams(streams)
        cap = int(flat.shape[0])
        a_st = (bstarts[:, None] + offs).astype("<i4").reshape(-1)
        a_en = (bstarts[:, None] + ends).astype("<i4").reshape(-1)
        a_eo = eobs.astype("<i4").reshape(-1)
        packed = np.concatenate([
            flat, a_st.view(np.uint8), a_en.view(np.uint8),
            a_eo.view(np.uint8),
        ])
        return dict(packed=packed, cap=cap, c=c, vidx=vidx,
                    nvalid=nvalid, huff=h, nblk_c=nblk_c,
                    ss=sc.ss, se=sc.se, al=sc.al)

    def _apply_ac_refine(self, s, state, sup_dev, row_idx, meta, B, jnp):
        """Dispatch one refinement scan's device VALUE pass, reading its
        packed buffer out of the shared [n_scans, capmax] super-upload."""
        import jax

        sc: ScanInfo = None  # only static meta below is used
        c = meta["c"]
        nvalid = meta["nvalid"]
        nblk_c = meta["nblk_c"]
        cap = meta["cap"]
        total_len = cap + 12 * B * nvalid
        key = ("acr", self._cur_key, s, B, row_idx,
               int(sup_dev.shape[1]), cap)
        fn = self._fns.get(key)
        if fn is None:
            kern = build_ac_refine_fn(
                batch=B, nvalid=nvalid, cap=cap,
                cmp=CmpTables([meta["huff"]]),
                ss=meta["ss"], se=meta["se"], al=meta["al"],
                k_pos=self.k2, W=self.W, _raw=True,
            )
            vj = jnp.asarray(meta["vidx"].astype(np.int64))

            def update(sup, st_c):
                pk = sup[row_idx, :total_len]
                cur = st_c.reshape(B, nblk_c, 64)[:, vj]  # [B, nv, 64]
                curT = jnp.transpose(cur, (2, 0, 1)).reshape(64, -1)
                deltaT, okd = kern(pk, curT)
                d_n = jnp.transpose(
                    deltaT.reshape(64, B, nvalid), (1, 2, 0)
                )
                new = st_c.reshape(B, nblk_c, 64).at[:, vj].add(d_n)
                return new.reshape(B, nblk_c * 64), okd

            fn = jax.jit(update)
            self._fns[key] = fn
        state[c], ok = fn(sup_dev, state[c])
        return ok

    # ---------------- public API

    def decode(self, datas: list[bytes]):
        """Decode a batch; batches over ``max_batch`` split into
        equal-shaped sub-batches (one compiled program each)."""
        if not datas:
            raise ValueError("jpeg: empty batch")
        mb = self.max_batch
        if mb and len(datas) > mb:
            import jax.numpy as jnp

            outs, ok = [], jnp.asarray(True)
            tails = 0
            for i in range(0, len(datas), mb):
                o, k = self._decode_chunk(datas[i : i + mb])
                outs.append(o)
                ok = ok & k
                tails = max(tails, self.n_host_tail_scans)
            self.n_host_tail_scans = tails
            return jnp.concatenate(outs, axis=0), ok
        return self._decode_chunk(datas)

    def _check_batch(self, plans):
        """Shared-script validation; sets self._cur_key/_cur_hv."""
        p0 = plans[0]

        def script_key(pl):
            return (
                pl.width, pl.height, pl.ncomp, pl.hv,
                tuple(
                    (s.comps, s.td, s.ta, s.ss, s.se, s.ah, s.al,
                     tuple(sorted(
                         # full canonical identity: symbols alone would
                         # collide for tables with equal symbol order
                         # but different code lengths
                         (k, t.num_codes, tuple(t.vals[: t.num_codes]),
                          tuple(t.min_codes), tuple(t.max_codes),
                          tuple(t.vals_indices))
                         for k, t in s.huffs.items()
                     )))
                    for s in pl.scans
                ),
            )

        k0 = script_key(p0)
        self._cur_key = k0
        self._cur_hv = p0.hv
        for pl in plans[1:]:
            if script_key(pl) != k0:
                raise UnsupportedError(
                    "jpeg: progressive batch must share geometry, scan "
                    "script, and tables"
                )
        if p0.ncomp not in (1, 3):
            raise UnsupportedError(
                "jpeg: on-chip progressive covers gray/YCbCr"
            )

    def _decode_chunk(self, datas: list[bytes]):
        import jax
        import jax.numpy as jnp
        plans = [parse_progressive(d) for d in datas]
        p0 = plans[0]
        self._check_batch(plans)
        B = len(datas)
        shapes = [
            (p0.myy * p0.hv[c][1], p0.mxx * p0.hv[c][0], 64)
            for c in range(p0.ncomp)
        ]
        state = [
            jnp.zeros((B, int(np.prod(shapes[c]))), jnp.int32)
            for c in range(p0.ncomp)
        ]

        # Round-5 hostindex mode (default): C++ lengths-only index
        # passes for EVERY scan up front (masks + EOB-run state evolve
        # host-side in script order — zero device store fetches), then
        # ONE super upload and ONE fused device dispatch for the whole
        # script.  An index pass that rejects a stream sends the batch
        # to the speculative-chunk path; a missing native runtime raises.
        if self.impl == "hostindex":
            hi = self._prep_hostindex(plans)
            if hi is not None:
                preps, sup, q_off = hi
                okh = all(
                    meta.get("okh", True)
                    for _ri, meta in preps.values()
                    if meta is not None
                )
                pr = dict(plans=plans, preps=preps, sup=sup, okh=okh,
                          q_off=q_off, key=self._cur_key)
                self.n_host_tail_scans = 0
                return self.run(pr)

        # Speculative-chunk path: device-decodable scans run in script
        # order; AC refinements use the host INDEX pass + device VALUE
        # pass split, with host-side masks seeded from ONE store fetch
        # at the first refinement.  Coverage breaks (-> host tail) only
        # on: multi-component ac_first, an ac_first AFTER a refinement
        # (the host masks would go stale), a missing native runtime, or
        # an index-pass error.
        ok = jnp.asarray(True)
        masks: dict = {}
        eob_runs = [0] * B
        ref_seeds = None
        ref_preps: dict = {}
        ref_sup = None
        n_prefix = len(p0.scans)
        for si in range(len(p0.scans)):
            s = p0.scans[si]
            kind = s.kind
            if kind == "ac_first" and (
                len(s.comps) != 1 or ref_seeds is not None
            ):
                n_prefix = si
                break
            if kind == "ac_refine":
                if len(s.comps) != 1:
                    n_prefix = si
                    break
                if ref_seeds is None:
                    # First refinement: (a) ONE store fetch seeds the
                    # host-side masks — only nonzero FLAGS travel (a
                    # device-side packbits shrinks the D2H transfer
                    # 32x); (b) ALL remaining
                    # refinement scans' host index passes run now
                    # (they depend only on the host masks) and their
                    # packed buffers ship in ONE device transfer.
                    import jax as _jx

                    pkf = self._recon_fns.get("_packbits")
                    if pkf is None:
                        pkf = _jx.jit(
                            lambda st: jnp.packbits(st != 0, axis=1)
                        )
                        self._recon_fns["_packbits"] = pkf
                    ref_seeds = [
                        np.unpackbits(
                            np.asarray(pkf(state[c])), axis=1
                        )[:, : int(state[c].shape[1])].reshape(B, -1, 64)
                        for c in range(p0.ncomp)
                    ]
                    ref_preps = {}
                    rows = []
                    for sj in range(si, len(p0.scans)):
                        sc2 = p0.scans[sj]
                        if sc2.kind == "ac_first":
                            break  # coverage guard (also checked above)
                        if sc2.kind != "ac_refine":
                            continue
                        if len(sc2.comps) != 1:
                            break
                        meta = self._prep_ac_refine(
                            plans, sj, masks, eob_runs, ref_seeds
                        )
                        if meta is None:
                            break
                        ref_preps[sj] = (len(rows), meta)
                        rows.append(meta["packed"])
                    if rows:
                        capmax = max(r.shape[0] for r in rows)
                        sup = np.zeros((len(rows), capmax), np.uint8)
                        for i, r in enumerate(rows):
                            sup[i, : r.shape[0]] = r
                        ref_sup = _jx.device_put(sup)
                if si not in ref_preps:
                    n_prefix = si
                    break
                ri, meta = ref_preps[si]
                ok = ok & self._apply_ac_refine(
                    si, state, ref_sup, ri, meta, B, jnp
                )
            elif kind == "dc_first":
                ok = ok & self._run_dc_first(plans, si, state, jnp)
            elif kind == "ac_first":
                ok = ok & self._run_ac_first(plans, si, state, jnp)
            else:
                ok = ok & self._run_dc_refine(plans, si, state, jnp)
        self.n_host_tail_scans = len(p0.scans) - n_prefix

        if n_prefix < len(p0.scans):
            # host tail: ONE store fetch seeds the refinement decode;
            # images are independent, so the tail runs threaded (the
            # native refinement scan releases the GIL)
            from concurrent.futures import ThreadPoolExecutor

            seeds = [
                np.asarray(state[c]).reshape((B,) + shapes[c])
                for c in range(p0.ncomp)
            ]

            def run_tail(b):
                tail = _TailScanDecoder(
                    datas[b], n_prefix,
                    [seeds[c][b] for c in range(p0.ncomp)],
                )
                return tail.run()

            import os as _os

            with ThreadPoolExecutor(
                max_workers=min(B, _os.cpu_count() or 2)
            ) as ex:
                decs = list(ex.map(run_tail, range(B)))
            for b, dec in enumerate(decs):
                for c in range(p0.ncomp):
                    diff = dec.coeff[c].astype(np.int64).reshape(-1) - \
                        seeds[c][b].astype(np.int64).reshape(-1)
                    nz = np.flatnonzero(diff)
                    if len(nz):
                        state[c] = state[c].at[b, jnp.asarray(nz)].add(
                            jnp.asarray(diff[nz].astype(np.int32))
                        )

        return self._reconstruct(plans, state, ok, B, jnp)

    def _reconstruct(self, plans, state, ok, B, jnp):
        """Dequant + IDCT + color device graph on the finished store."""
        import jax

        from .batch import _gray_graph, _ycbcr_graph

        p0 = plans[0]
        shapes = [
            (p0.myy * p0.hv[c][1], p0.mxx * p0.hv[c][0], 64)
            for c in range(p0.ncomp)
        ]
        quants = [
            jnp.asarray(np.stack([pl.quants[c] for pl in plans]))
            for c in range(p0.ncomp)
        ]
        key = (self._cur_key[:4], B)
        fn = self._recon_fns.get(key)
        if fn is None:

            def recon(st, qs):
                grids = [
                    st[c].reshape((B,) + shapes[c])
                    for c in range(p0.ncomp)
                ]
                if p0.ncomp == 1:
                    return _gray_graph(
                        grids[0], qs[0], height=p0.height, width=p0.width
                    )
                return _ycbcr_graph(
                    grids[0], grids[1], grids[2], *qs,
                    height=p0.height, width=p0.width, ratio=p0.ratio,
                )

            fn = jax.jit(recon)
            self._recon_fns[key] = fn
        return fn(state, quants), ok

    def decode_verified(self, datas: list[bytes]) -> np.ndarray:
        """Host numpy output with whole-batch host fallback on ok=False."""
        out, ok = self.decode(datas)
        if bool(ok):
            return np.asarray(out)
        from ..codecs.jpeg import decoder as host

        outs = []
        for d in datas:
            img = host.decode(d)
            from ..color import ycbcr_to_rgb8

            if img.__class__.__name__ == "GrayImage":
                outs.append(img.pix)
            else:
                cb, cr = img.upsampled_cbcr()
                r, g, b = ycbcr_to_rgb8(img.y, cb, cr)
                outs.append(np.stack([r, g, b], axis=-1))
        return np.stack(outs)
