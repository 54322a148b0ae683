"""On-chip QOI decode: chunked speculative scan with exact verification.

The QOI op stream (reference /root/reference/src/qoi/decoder.zig:20-130) is
serial by construction: every op updates a previous-pixel register and a
64-entry rolling index keyed by (3r+5g+7b+11a)&63, and OP_INDEX reads back
arbitrary history.  But ops are byte-aligned and self-delimiting (the first
byte alone determines the op length: OP_RGB=4, OP_RGBA=5, OP_LUMA=2, else 1),
so the same fixed-point machinery as the restart-free JPEG path
(device_entropy_sync) applies with *byte* chunks and a wider lane state:

1. **Speculative scan.**  The stream is cut into fixed CHUNK_BYTES chunks;
   every chunk lane decodes ops from its entry state, guessing
   (pos=chunk_start, px=(0,0,0,255), index=zeros).  Exit state =
   (byte pos of the first op boundary at/past the chunk end, px, index).
2. **Fixed-point propagation.**  entries[i] := exits[i-1] (chunk 0 pinned to
   the true initial state); rescan until no entry changes.  Convergence is
   guaranteed in <= F rounds (after round r, chunks 0..r-1 are exact), and
   the fixed point IS the serial decode by induction — verification is
   exact, not probabilistic.  In practice the index table is mostly
   rewritten within one chunk, so 2-4 rounds converge.
3. **Record scan.**  One more scan from converged entries records each op's
   (packed RGBA color, emitted pixel count) into per-chunk capacity slots
   (one-hot accumulation — no scatter).
4. **Assembly.**  Per-image cumsum of counts + one searchsorted expands
   run-length (color, count) pairs into the [H*W] pixel raster; pixels past
   the emitted total replicate the final decoder px (the reference's
   stream-exhausted fill, decoder.zig:67-69 / codecs/qoi/decode.py:96-103).

ok=False (scan error, slot overflow, or op reading past the image's padded
end) -> callers fall back to the host decoder for parity.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..errors import FormatError, UnsupportedError
from ..codecs.qoi.decode import QOI_HEADER_SIZE, QOI_PADDING_SIZE, _parse_header

_DEF_CHUNK = int(os.environ.get("ZPIX_QOI_CHUNK", "64"))
_DEF_K = int(os.environ.get("ZPIX_QOI_K", "4"))
# record-slot capacity per chunk as a fraction of chunk_bytes (1 = the
# exact worst case of one op per byte; production content runs 4-5 B/op,
# so a divisor of 3-4 shrinks the dominant [mcap, L] record carry with
# overflow detected exactly -> ok=False -> host fallback)
_DEF_OPS_DIV = int(os.environ.get("ZPIX_QOI_OPS_DIV", "1"))
# share of the device's memory limit one decode's while-loop carry may
# take (the loop holds the old and the new carry, plus temporaries)
_CARRY_SHARE = 0.25


def device_carry_mb() -> float | None:
    """Carry budget in MB: a quarter of the default device's
    ``memory_stats()["bytes_limit"]``; None when the device reports no
    limit (the CPU), which leaves the carry unbounded."""
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    limit = stats.get("bytes_limit")
    return None if limit is None else limit * _CARRY_SHARE / 1e6


def carry_bytes(plan: "QoiPlan", ops_cap: int | None = None,
                groups: int = 1) -> int:
    """Worst-case while-loop carry footprint of the decode program.

    pos/px/cnt (3 x i32/u32) + done/err (2 x bool) + idx [64, L] u32 per
    lane, plus record cols [mcap, Lg] u32 + cnts [mcap, Lg] i16 where
    Lg = L / groups (the record scan runs as ``groups`` sequential while
    loops over lane slices; only one slice's records sit in a carry at a
    time — the sync scans carry no records)."""
    L = plan.batch * plan.n_chunks
    mcap = min(plan.chunk_bytes, ops_cap or plan.chunk_bytes)
    per_lane = 3 * 4 + 2 + 64 * 4
    return L * per_lane + (L // max(1, groups)) * mcap * (4 + 2)


def _pick_groups(plan: "QoiPlan", ops_cap: int | None,
                 carry_mb: float | None) -> int:
    """Smallest power-of-two divisor of the batch that fits the budget."""
    g = 1
    while (carry_mb is not None
           and carry_bytes(plan, ops_cap, g) > carry_mb * 1e6
           and g < plan.batch and plan.batch % (g * 2) == 0):
        g *= 2
    return g


def _adaptive_chunk(stream_bytes: int) -> int:
    """Default chunk size scaled to the stream: keep chunks-per-image
    ~<= 1500 so (a) per-round lane work stays bounded and (b) the
    fixed point's rare cross-chunk index chains stay short: thousands
    of small chunks per megapixel stream need as many sync rounds."""
    if os.environ.get("ZPIX_QOI_CHUNK"):
        return _DEF_CHUNK
    cb = _DEF_CHUNK
    while stream_bytes // cb > 1500 and cb < 65536:
        cb *= 2
    return cb


@dataclass
class QoiPlan:
    """Host-side prep of a same-dimensions QOI batch."""

    width: int
    height: int
    stream: np.ndarray  # op streams (+ their 8-byte padding) back to back
    img_byte_start: np.ndarray  # int32 [B] first op byte
    img_byte_end: np.ndarray  # int32 [B] end of op bytes (excl. padding)
    img_raw_end: np.ndarray  # int32 [B] end incl. the 8-byte padding
    chunk_bytes: int
    n_chunks: int  # per image (padded to the longest op stream)
    batch: int
    cache_key: tuple = None


def prep_qoi_batch(datas: list[bytes], chunk_bytes: int | None = None,
                   cap_hint: int | None = None) -> QoiPlan:
    """cap_hint: minimum stream-buffer capacity (shared-layout batches,
    see device_entropy.prep_batch)."""
    if not datas:
        raise ValueError("qoi: empty batch")
    cb = chunk_bytes or _adaptive_chunk(max(len(d) for d in datas))
    dims = None
    regions = []
    for d in datas:
        w, h, _, _ = _parse_header(d)
        if dims is None:
            dims = (w, h)
        elif dims != (w, h):
            raise UnsupportedError("qoi: batch must share dimensions")
        # op bytes plus the trailing 8-byte padding (reads may run into it,
        # mirroring the host decoder's p+k <= len(d) guards)
        regions.append(np.frombuffer(d, np.uint8)[QOI_HEADER_SIZE:])

    offs, total = [], 0
    for r in regions:
        offs.append(total)
        total += (len(r) + 7) // 8 * 8
    cap = 1 << max(12, (max(total + 16, cap_hint or 0) - 1).bit_length())
    flat = np.zeros(cap, np.uint8)
    for r, o in zip(regions, offs):
        flat[o : o + len(r)] = r
    op_lens = [len(r) - QOI_PADDING_SIZE for r in regions]
    return QoiPlan(
        width=dims[0], height=dims[1], stream=flat,
        img_byte_start=np.array(offs, np.int32),
        img_byte_end=np.array(
            [o + n for o, n in zip(offs, op_lens)], np.int32
        ),
        img_raw_end=np.array(
            [o + len(r) for o, r in zip(offs, regions)], np.int32
        ),
        chunk_bytes=cb,
        # bucket the chunk count (extra chunks start past img_byte_end
        # and stay inactive) so distinct-content batches share compiled
        # programs; the count also keys the program cache below
        n_chunks=((max(op_lens) + cb - 1) // cb + 31) // 32 * 32,
        batch=len(datas),
        cache_key=(dims, len(datas), cb),
    )


def build_qoi_decode_fn(plan: QoiPlan, *, k_ops: int | None = None,
                        max_rounds: int | None = None, _raw: bool = False,
                        mesh=None, ops_cap: int | None = None,
                        win_words: int | None = None,
                        record_groups: int | None = None,
                        carry_mb: float | None = None,
                        _stage: str = "full"):
    """Returns a jitted fn: (stream, img_byte_start, img_byte_end,
    img_raw_end) -> (rgba [B, H, W, 4] uint8, ok flag).

    Lane discipline follows the round-2 JPEG treatment (device_entropy):
    ONE [L, W]-word window row-gather per while step feeds a K-op
    unrolled body (vs a gather per op), every lane-sized carry keeps the
    huge L axis MINOR ([64, L] index table, [mcap, L] records), and the
    record counts are int16.  ``ops_cap`` bounds record slots per chunk
    below the 1-op-per-byte worst case; overflow is detected exactly and
    reported as ok=False (host fallback keeps parity).

    mesh: shard the lane state over the mesh 'batch' axis.  Lanes are
    batch-major ([L] = [B, F] flattened), so a trailing-axis shard keeps
    every image's chunk lanes on one device; the compressed stream
    stays replicated (each lane gathers arbitrary offsets of it)."""
    import jax
    import jax.numpy as jnp

    from .device_entropy import _bits_at

    lane_sh = lane2_sh = out_sh = None
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        lane_sh = NamedSharding(mesh, P("batch"))
        lane2_sh = NamedSharding(mesh, P(None, "batch"))  # [X, L] lane-minor
        out_sh = NamedSharding(mesh, P("batch"))

    def _lane(x):
        if lane_sh is None:
            return x
        return jax.lax.with_sharding_constraint(x, lane_sh)

    def _lane2(x):
        if lane2_sh is None:
            return x
        return jax.lax.with_sharding_constraint(x, lane2_sh)

    def _b(x):
        """Constrain a [B, ...] per-image array onto the batch axis."""
        if out_sh is None:
            return x
        return jax.lax.with_sharding_constraint(x, out_sh)

    B = plan.batch
    F = plan.n_chunks
    L = B * F
    CB = plan.chunk_bytes
    if ops_cap is None and _DEF_OPS_DIV > 1:
        ops_cap = max(1, CB // _DEF_OPS_DIV)
    mcap = min(CB, ops_cap or CB)  # record slots per chunk
    GROUPS = record_groups or _pick_groups(
        plan, mcap, device_carry_mb() if carry_mb is None else carry_mb
    )
    npx = plan.width * plan.height
    K = k_ops if k_ops is not None else _DEF_K
    # window: covers K ops of <= 5 bytes plus read slack; each while
    # step does ONE [L, W] row gather and the unrolled ops read bytes
    # at their running offset via cheap word selects (_bits_at)
    W = win_words if win_words is not None else max(3, min(20, (5 * K + 11) // 4))
    off_lim = 4 * W - 8  # b1 at off, b2..b5 as one 32-bit read at off+1
    rounds_cap = max_rounds if max_rounds is not None else F + 2
    step_cap = CB + 2  # absolute while-step cap (early-exits on done)

    PX0 = np.uint32(0x000000FF)  # r=g=b=0, a=255 (decoder.zig:60-62)

    def decode_impl(stage, stream, img_byte_start, img_byte_end,
                    img_raw_end, e_pos=None, e_px=None, e_idx=None):
        u32 = jnp.uint32
        i32 = jnp.int32
        s = stream.astype(u32)
        # The JPEG-style per-byte-offset window table ([cap, W] u32)
        # would be W*4x the stream — gigabytes at QOI stream sizes.
        # QOI positions are BYTE
        # aligned, so instead keep one 4-byte-aligned big-endian word
        # array (cap bytes total) and per step gather [L, W+1]
        # consecutive words + rotate by (byte & 3) per lane.
        n4 = stream.shape[0] // 4
        al4 = (
            (s[0 : 4 * n4 : 4] << 24) | (s[1 : 4 * n4 : 4] << 16)
            | (s[2 : 4 * n4 : 4] << 8) | s[3 : 4 * n4 : 4]
        )
        n = 4 * (n4 - (W + 2))  # max safe byte index for a window read
        warange = jnp.arange(W + 1)

        def fetch(byte):
            wi = byte >> 2
            w4 = al4[wi[:, None] + warange[None, :]]  # [L, W+1]
            sh = ((byte & 3) * 8).astype(u32)[:, None]
            lo = w4[:, :-1] << sh
            hi = jnp.where(
                sh > 0, w4[:, 1:] >> (u32(32) - sh), u32(0)
            )
            w = lo | hi
            return tuple(w[:, j] for j in range(W))

        img_start = img_byte_start.astype(i32)
        img_end = img_byte_end.astype(i32)
        raw_end = img_raw_end.astype(i32)
        lane_img = jnp.repeat(jnp.arange(B), F)  # [L]
        lane_chunk = jnp.tile(jnp.arange(F), B)  # [L]
        chunk_start = jnp.minimum(
            img_start[lane_img] + lane_chunk * CB, img_end[lane_img]
        )
        chunk_end = jnp.minimum(chunk_start + CB, img_end[lane_img])
        lane_raw_end = raw_end[lane_img]
        slots = jnp.arange(64, dtype=i32)[:, None]  # [64, 1] (lane-minor)

        def scan_chunks(entries, record, lo=0, hi=None):
            """Scan lanes [lo:hi) (the record scan runs in lane groups so
            its [mcap, Lg] record arrays bound the while carry)."""
            hi = L if hi is None else hi
            Lg = hi - lo
            e_pos, e_px, e_idx = (
                entries[0][lo:hi], entries[1][lo:hi], entries[2][:, lo:hi]
            )
            g_chunk_end = chunk_end[lo:hi]
            g_raw_end = lane_raw_end[lo:hi]

            def body(st):
                pos, px, idx, done, err, cols, cnts, cnt, steps = st
                byte = jnp.clip(pos, 0, n - 1)
                w = fetch(byte)  # one row gather per step
                off = jnp.zeros_like(pos)
                emits = []
                for _ in range(K):
                    active = (~done) & (off <= off_lim)
                    b1 = _bits_at(jnp, w, off * 8, 8).astype(i32)
                    rest = _bits_at(jnp, w, off * 8 + 8, 32)  # b2..b5
                    b2 = (rest >> 24).astype(i32)
                    b3 = ((rest >> 16) & 0xFF).astype(i32)
                    b4 = ((rest >> 8) & 0xFF).astype(i32)
                    b5 = (rest & 0xFF).astype(i32)

                    is_rgb = b1 == 0xFE
                    is_rgba = b1 == 0xFF
                    tag = b1 >> 6
                    lit = ~(is_rgb | is_rgba)

                    r = ((px >> 24) & 0xFF).astype(i32)
                    g = ((px >> 16) & 0xFF).astype(i32)
                    bl = ((px >> 8) & 0xFF).astype(i32)
                    a = (px & 0xFF).astype(i32)

                    # OP_INDEX: gather-free one-hot read of the rolling table
                    j = b1 & 63
                    hit = slots == j[None, :]  # [64, L]
                    px_idx = jnp.sum(jnp.where(hit, idx, u32(0)), axis=0)
                    ir = ((px_idx >> 24) & 0xFF).astype(i32)
                    ig = ((px_idx >> 16) & 0xFF).astype(i32)
                    ib = ((px_idx >> 8) & 0xFF).astype(i32)
                    ia = (px_idx & 0xFF).astype(i32)

                    # OP_DIFF: 2-bit biased deltas (decoder.zig:97-101)
                    dr2 = ((b1 >> 4) & 3) - 2
                    dg2 = ((b1 >> 2) & 3) - 2
                    db2 = (b1 & 3) - 2
                    # OP_LUMA: 6+4+4-bit biased (decoder.zig:103-110)
                    dgl = (b1 & 63) - 32
                    drl = dgl + ((b2 >> 4) & 15) - 8
                    dbl = dgl + (b2 & 15) - 8

                    t_idx = lit & (tag == 0)
                    t_diff = lit & (tag == 1)
                    t_luma = lit & (tag == 2)
                    t_run = lit & (tag == 3)

                    nr = jnp.where(is_rgb | is_rgba, b2, r)
                    ng = jnp.where(is_rgb | is_rgba, b3, g)
                    nb = jnp.where(is_rgb | is_rgba, b4, bl)
                    na = jnp.where(is_rgba, b5, a)
                    nr = jnp.where(t_idx, ir, nr)
                    ng = jnp.where(t_idx, ig, ng)
                    nb = jnp.where(t_idx, ib, nb)
                    na = jnp.where(t_idx, ia, na)
                    nr = jnp.where(t_diff, (r + dr2) & 0xFF, nr)
                    ng = jnp.where(t_diff, (g + dg2) & 0xFF, ng)
                    nb = jnp.where(t_diff, (bl + db2) & 0xFF, nb)
                    nr = jnp.where(t_luma, (r + drl) & 0xFF, nr)
                    ng = jnp.where(t_luma, (g + dgl) & 0xFF, ng)
                    nb = jnp.where(t_luma, (bl + dbl) & 0xFF, nb)

                    size = jnp.where(
                        is_rgb, 4, jnp.where(is_rgba, 5, jnp.where(t_luma, 2, 1))
                    )
                    emit = jnp.where(t_run, (b1 & 63) + 1, 1)
                    bad = active & (pos + off + size > g_raw_end)
                    app = active & ~bad

                    new_px = (
                        (nr.astype(u32) << 24)
                        | (ng.astype(u32) << 16)
                        | (nb.astype(u32) << 8)
                        | na.astype(u32)
                    )
                    px = jnp.where(app, new_px, px)
                    h = ((nr * 3 + ng * 5 + nb * 7 + na * 11) & 63)
                    wr = app[None, :] & (slots == h[None, :])  # [64, L]
                    idx = jnp.where(wr, px[None, :], idx)

                    if record:
                        over = cnt >= mcap
                        emits.append((
                            jnp.clip(cnt, 0, mcap - 1),
                            jnp.where(app & ~over, px, u32(0)),
                            jnp.where(app & ~over, emit, 0).astype(jnp.int16),
                        ))
                        err = err | (app & over)
                    cnt = jnp.where(app, cnt + 1, cnt)
                    off = jnp.where(app, off + size, off)
                    err = err | bad
                    done = done | (pos + off >= g_chunk_end) | bad
                if record:
                    # ONE [mcap, L] one-hot accumulation per step (lane
                    # axis minor — the JPEG pass-1 emission discipline)
                    arb = jnp.arange(mcap)[:, None]
                    cols = cols + sum(
                        jnp.where(ci[None, :] == arb, cv[None, :], u32(0))
                        for ci, cv, _ in emits
                    )
                    cnts = cnts + sum(
                        jnp.where(ci[None, :] == arb, ev[None, :], jnp.int16(0))
                        for ci, _, ev in emits
                    )
                pos = pos + off
                return (pos, px, idx, done, err, cols, cnts, cnt, steps + 1)

            def cond(st):
                return (jnp.sum(st[3].astype(i32)) < Lg) & (st[8] < step_cap)

            shape1 = (mcap if record else 1, Lg)
            st = jax.lax.while_loop(
                cond,
                body,
                (
                    e_pos,
                    e_px,
                    e_idx,
                    e_pos >= g_chunk_end,
                    jnp.zeros(Lg, bool),
                    jnp.zeros(shape1, u32),
                    jnp.zeros(shape1, jnp.int16),
                    jnp.zeros(Lg, i32),
                    jnp.int32(0),
                ),
            )
            return st

        # ---- speculative sync to a fixed point
        guess = (
            _lane(chunk_start),
            _lane(jnp.full(L, PX0, u32)),
            _lane2(jnp.zeros((64, L), u32)),
        )
        if stage == "init":
            return guess

        def shift(exits):
            """entries[i] := exits[i-1] within each image."""
            pos, px, idx = exits
            pos2 = pos.reshape(B, F)
            px2 = px.reshape(B, F)
            idx2 = idx.reshape(64, B, F)
            return (
                jnp.concatenate([img_start[:, None], pos2[:, :-1]], 1).reshape(L),
                jnp.concatenate(
                    [jnp.full((B, 1), PX0, u32), px2[:, :-1]], 1
                ).reshape(L),
                jnp.concatenate(
                    [jnp.zeros((64, B, 1), u32), idx2[:, :, :-1]], 2
                ).reshape(64, L),
            )

        def sync_round(st):
            entries, _chg, rounds = st
            sc = scan_chunks(entries, record=False)
            new_entries = shift((sc[0], sc[1], sc[2]))
            chg = jnp.zeros((), bool)
            for aa, bb in zip(new_entries, entries):
                chg = chg | jnp.any(aa != bb)
            return (new_entries, chg, rounds + 1)

        if stage == "sync_block":
            # Bounded-round block for the HOST-orchestrated fixed point:
            # the host dispatches <= R_BLOCK rounds at a time and
            # early-exits on the fetched convergence flag.
            st = ((e_pos, e_px, e_idx), jnp.ones((), bool), jnp.int32(0))
            st = jax.lax.while_loop(
                lambda s: s[1] & (s[2] < R_BLOCK), sync_round, st
            )
            (p_, x_, i_), chg, _ = st
            return p_, x_, i_, chg

        if stage == "finish":
            entries = (e_pos, e_px, e_idx)
        else:
            st = ((guess), jnp.ones((), bool), jnp.int32(0))
            st = jax.lax.while_loop(
                lambda s: s[1] & (s[2] < rounds_cap), sync_round, st
            )
            entries = st[0]

        if stage == "sync":  # debug: fixed-point rounds only
            return (jnp.sum(entries[0].astype(jnp.uint32))
                    + jnp.sum(entries[1])), jnp.asarray(True)

        # ---- record scan from converged entries, in GROUPS lane groups
        # (each group's [mcap, Lg] records are the only big while carry;
        # sequential groups bound peak carry to the carry budget)
        cols_p, cnts_p, px_p, done_p, err_p = [], [], [], [], []
        for g_ in range(GROUPS):
            lo, hi = g_ * L // GROUPS, (g_ + 1) * L // GROUPS
            sc = scan_chunks(entries, record=True, lo=lo, hi=hi)
            cols_p.append(sc[5])
            cnts_p.append(sc[6])
            px_p.append(sc[1])
            done_p.append(sc[3])
            err_p.append(sc[4])
        cols = jnp.concatenate(cols_p, axis=1)  # [mcap, L] lane-minor
        cnts = jnp.concatenate(cnts_p, axis=1)
        scan_ok = (jnp.all(jnp.concatenate(done_p))
                   & ~jnp.any(jnp.concatenate(err_p)))
        if stage == "scan":  # debug: scan only (crash bisection probe)
            return (jnp.sum(cols, dtype=jnp.uint32)
                    + jnp.sum(cnts.astype(jnp.int32)).astype(jnp.uint32)), \
                scan_ok
        # decoder px at stream end (last chunk lane of each image)
        fill_px = jnp.concatenate(px_p).reshape(B, F)[:, -1]

        # ---- run expansion: (color, count) pairs -> pixel raster
        # [mcap, B, F] -> [B, F, mcap]: per-image ops in (chunk, slot) order
        to_img = lambda a: jnp.transpose(  # noqa: E731
            a.reshape(mcap, B, F), (1, 2, 0)
        ).reshape(B, F * mcap)
        cnts_img = to_img(cnts.astype(i32))
        cols_img = to_img(cols)
        cum = jnp.cumsum(cnts_img, axis=1)  # [B, F*mcap]
        total = cum[:, -1]
        gpix = jnp.arange(npx)

        def expand(cum_b, cols_b, total_b, fill_b):
            op = jnp.searchsorted(cum_b, gpix, side="right")
            c = cols_b[jnp.clip(op, 0, F * mcap - 1)]
            return jnp.where(gpix < total_b, c, fill_b)

        cum, cols_img, total, fill_px = (
            _b(cum), _b(cols_img), _b(total), _b(fill_px)
        )
        packed = jax.vmap(expand)(cum, cols_img, total, fill_px)  # [B, npx] u32
        rgba = jnp.stack(
            [
                (packed >> 24).astype(jnp.uint8),
                ((packed >> 16) & 0xFF).astype(jnp.uint8),
                ((packed >> 8) & 0xFF).astype(jnp.uint8),
                (packed & 0xFF).astype(jnp.uint8),
            ],
            axis=-1,
        ).reshape(B, plan.height, plan.width, 4)
        return _b(rgba), scan_ok

    from functools import partial

    R_BLOCK = int(os.environ.get("ZPIX_QOI_ROUNDS_PER_CALL", "4"))

    if _raw:
        return partial(decode_impl, _stage)
    if mesh is not None or _stage != "full" or os.environ.get(
        "ZPIX_QOI_ONESHOT", "0"
    ) == "1":
        # single-program form: CPU-mesh tests, debug stages, sharded path
        return jax.jit(partial(decode_impl, _stage))

    # Host-orchestrated form (single-device default): the fixed point
    # runs as bounded-round dispatches with a host early-exit on the
    # convergence flag, then the record scan + assembly dispatch once.
    # Each dispatch's runtime stays bounded, and the host can stop as
    # soon as the entries converge, at the cost of one small D2H fetch
    # per R_BLOCK rounds.
    init_jit = jax.jit(partial(decode_impl, "init"))
    sync_jit = jax.jit(partial(decode_impl, "sync_block"))
    finish_jit = jax.jit(partial(decode_impl, "finish"))

    def orchestrated(stream, img_byte_start, img_byte_end, img_raw_end):
        args = (stream, img_byte_start, img_byte_end, img_raw_end)
        e = init_jit(*args)
        total = 0
        chg = True
        while chg and total < rounds_cap:
            p_, x_, i_, chgd = sync_jit(*args, *e)
            e = (p_, x_, i_)
            total += R_BLOCK
            chg = bool(chgd)
        rgba, ok = finish_jit(*args, *e)
        if chg:  # rounds exhausted without convergence (cannot happen
            ok = ok & False  # for <= F rounds; exactness guard anyway)
        return rgba, ok

    return orchestrated


class BatchQoiDecoder:
    """Fully on-chip batched QOI decode (bytes -> device RGBA8 [B,H,W,4]).

    Exact-by-construction speculative chunk scan (module docstring); on
    ok=False ``decode_verified`` falls back to the host decoder
    (codecs/qoi/decode.py) per image.
    """

    def __init__(self, *, chunk_bytes: int | None = None,
                 k_ops: int | None = None, mesh=None,
                 ops_cap: int | None = None, win_words: int | None = None,
                 carry_mb: float | None = None):
        self.chunk_bytes = chunk_bytes
        self.k_ops = k_ops
        self.mesh = mesh
        self.ops_cap = ops_cap
        self.win_words = win_words
        # carry budget in MB; None derives it from the device (see
        # device_carry_mb)
        self.carry_mb = device_carry_mb() if carry_mb is None else carry_mb
        self._fns: dict = {}

    def _effective_ops_cap(self, plan: QoiPlan) -> int | None:
        if self.ops_cap is not None:
            return self.ops_cap
        if _DEF_OPS_DIV > 1:
            return max(1, plan.chunk_bytes // _DEF_OPS_DIV)
        return None

    def _guard(self, plan: QoiPlan):
        """Refuse programs whose while carry would not fit the carry
        budget.  The record scan auto-splits into lane groups first; the
        guard trips only when even the finest split exceeds the budget."""
        if self.carry_mb is None:
            return
        cap = self._effective_ops_cap(plan)
        g = _pick_groups(plan, cap, self.carry_mb)
        cb = carry_bytes(plan, cap, g)
        if cb > self.carry_mb * 1e6:
            raise UnsupportedError(
                f"qoi: decode while-carry {cb / 1e6:.0f} MB exceeds the "
                f"{self.carry_mb:.0f} MB guard (batch={plan.batch}, "
                f"chunks={plan.n_chunks}, chunk_bytes={plan.chunk_bytes}); "
                "shrink the batch, raise ZPIX_QOI_OPS_DIV, or use the host "
                "decoder"
            )

    def decode(self, datas: list[bytes]):
        import jax

        from ..utils import metrics, trace

        with trace("qoi_onchip.prep"):
            plan = prep_qoi_batch(datas, self.chunk_bytes)
        self._guard(plan)
        metrics.count("qoi_onchip.images", len(datas))
        key = (plan.cache_key, int(plan.stream.shape[0]), plan.n_chunks)
        fn = self._fns.get(key)
        if fn is None:
            fn = build_qoi_decode_fn(plan, k_ops=self.k_ops, mesh=self.mesh,
                                     ops_cap=self.ops_cap,
                                     win_words=self.win_words,
                                     carry_mb=self.carry_mb)
            self._fns[key] = fn
        if self.mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            rep = NamedSharding(self.mesh, P())  # stream: every lane gathers
            bsh = NamedSharding(self.mesh, P("batch"))
            return fn(
                jax.device_put(plan.stream, rep),
                jax.device_put(plan.img_byte_start, bsh),
                jax.device_put(plan.img_byte_end, bsh),
                jax.device_put(plan.img_raw_end, bsh),
            )
        return fn(
            jax.device_put(plan.stream),
            jax.device_put(plan.img_byte_start),
            jax.device_put(plan.img_byte_end),
            jax.device_put(plan.img_raw_end),
        )

    def decode_verified(self, datas: list[bytes]) -> np.ndarray:
        """Host numpy output with per-batch host fallback on ok=False
        (or when the carry guard refuses to dispatch)."""
        try:
            rgba, ok = self.decode(datas)
        except UnsupportedError:
            ok = False
        if ok is not False and bool(ok):
            return np.asarray(rgba)
        from ..codecs.qoi.decode import decode as host_decode

        return np.stack([host_decode(d).pix for d in datas])


# ---------------------------------------------------------------------------
# Host-index / device-expansion split (round 4) — the QOI analog of the
# restart-free JPEG HostIndexJpegDecoder (device_entropy).
#
# The speculative fixed point above is exact but converges too slowly at
# production scale: a rolling-index slot written once early in the stream
# propagates through downstream chunk lanes ONE ROUND each, so a
# megapixel stream needs about as many rounds as it has chunks.  QOI's
# serial byte walk is O(ops) scalar work — what a host core does at
# memory speed — while the O(pixels) run expansion is pure vector work.
# So: host C++ pass (runtime/qoi.cpp::zpix_qoi_record_scan) emits per-op
# (packed RGBA, count<=62) records; the device expands records into the
# raster with one cumsum + searchsorted per image.  Ships O(ops) bytes
# (<= 5 B/op vs 4 B/px raster; far less on run-heavy content).
# Reference serial loop: /root/reference/src/qoi/decoder.zig:20-130.
# ---------------------------------------------------------------------------


@dataclass
class QoiRecordPlan:
    """Host record pass over a same-dimensions QOI batch."""

    width: int
    height: int
    cols: np.ndarray  # [B, rcap] uint32 packed 0xRRGGBBAA
    cnts: np.ndarray  # [B, rcap] uint8, 0 past each image's records
    fill: np.ndarray  # [B] uint32 final decoder px (stream-exhausted fill)
    batch: int
    rcap: int


def _record_scan_py(data: bytes, pixel_count: int):
    """Pure-Python twin of zpix_qoi_record_scan (ZPIX_NATIVE=0 path)."""
    from ..codecs.qoi.decode import QOI_HEADER_SIZE, QOI_PADDING_SIZE

    n = len(data)
    if n < QOI_HEADER_SIZE + QOI_PADDING_SIZE:  # native rc=1
        raise FormatError("qoi: short stream")
    p = QOI_HEADER_SIZE
    chunks_len = n - QOI_PADDING_SIZE
    index = [0] * 64
    px = 0x000000FF
    cols, cnts = [], []
    total = 0
    while total < pixel_count and p < chunks_len:
        b1 = data[p]
        p += 1
        cnt = 1
        if b1 == 0xFE:
            if p + 3 > n:  # native rc=2 (truncated op tail)
                raise FormatError("qoi: truncated op")
            px = (data[p] << 24) | (data[p + 1] << 16) | (data[p + 2] << 8) \
                | (px & 0xFF)
            p += 3
        elif b1 == 0xFF:
            if p + 4 > n:
                raise FormatError("qoi: truncated op")
            px = (data[p] << 24) | (data[p + 1] << 16) | (data[p + 2] << 8) \
                | data[p + 3]
            p += 4
        else:
            tag = b1 & 0xC0
            if tag == 0x00:
                px = index[b1 & 0x3F]
            elif tag == 0x40:
                r = ((px >> 24) + ((b1 >> 4) & 3) - 2) & 0xFF
                g = (((px >> 16) & 0xFF) + ((b1 >> 2) & 3) - 2) & 0xFF
                b = (((px >> 8) & 0xFF) + (b1 & 3) - 2) & 0xFF
                px = (r << 24) | (g << 16) | (b << 8) | (px & 0xFF)
            elif tag == 0x80:
                if p >= n:
                    raise FormatError("qoi: truncated op")
                b2 = data[p]
                p += 1
                dg = (b1 & 0x3F) - 32
                r = ((px >> 24) + dg + ((b2 >> 4) & 0xF) - 8) & 0xFF
                g = (((px >> 16) & 0xFF) + dg) & 0xFF
                b = (((px >> 8) & 0xFF) + dg + (b2 & 0xF) - 8) & 0xFF
                px = (r << 24) | (g << 16) | (b << 8) | (px & 0xFF)
            else:
                cnt = (b1 & 0x3F) + 1
        h = (((px >> 24) * 3 + ((px >> 16) & 0xFF) * 5
              + ((px >> 8) & 0xFF) * 7 + (px & 0xFF) * 11) & 63)
        index[h] = px
        cnt = min(cnt, pixel_count - total)
        cols.append(px)
        cnts.append(cnt)
        total += cnt
    return (np.array(cols, np.uint32), np.array(cnts, np.uint8),
            np.uint32(px))


def _record_scan_native(data: bytes, pixel_count: int):
    import ctypes

    from .. import runtime

    lib = runtime.get_lib()
    rcap = max(1, len(data))  # one op is >= 1 byte
    cols = np.empty(rcap, np.uint32)
    cnts = np.empty(rcap, np.uint8)
    n_out = ctypes.c_int64()
    fill = ctypes.c_uint32()
    rc = lib.zpix_qoi_record_scan(
        data, len(data), pixel_count,
        cols.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        cnts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        rcap, ctypes.byref(n_out), ctypes.byref(fill),
    )
    if rc != 0:
        raise FormatError(f"qoi: record scan failed (rc={rc})")
    n = n_out.value
    return cols[:n], cnts[:n], np.uint32(fill.value)


def prep_qoi_records(datas: list[bytes], rcap_hint: int | None = None
                     ) -> QoiRecordPlan:
    """Host record pass (threaded across the batch).  rcap pads to the
    next 64Ki multiple (>= rcap_hint) so step batches share one compiled
    expansion program."""
    import os as _os
    from concurrent.futures import ThreadPoolExecutor

    from .. import runtime

    if not datas:
        raise ValueError("qoi: empty batch")
    w, h, _c, _cs = _parse_header(datas[0])
    npx = w * h
    for d in datas[1:]:
        w2, h2, _c2, _cs2 = _parse_header(d)
        if (w2, h2) != (w, h):
            raise UnsupportedError("qoi: mixed dimensions in batch")

    native = runtime.get_lib() is not None and hasattr(
        runtime.get_lib(), "zpix_qoi_record_scan")
    scan = _record_scan_native if native else _record_scan_py
    with ThreadPoolExecutor(
        max_workers=min(len(datas), _os.cpu_count() or 2)
    ) as ex:
        parts = list(ex.map(lambda d: scan(d, npx), datas))

    need = max(p[0].shape[0] for p in parts)
    rcap = max(need, rcap_hint or 0, 1)
    rcap = -(-rcap // 65536) * 65536  # 64Ki buckets: shared layouts
    B = len(datas)
    cols = np.zeros((B, rcap), np.uint32)
    cnts = np.zeros((B, rcap), np.uint8)
    fill = np.empty(B, np.uint32)
    for i, (c, n, f) in enumerate(parts):
        cols[i, : c.shape[0]] = c
        cnts[i, : n.shape[0]] = n
        fill[i] = f
    return QoiRecordPlan(w, h, cols, cnts, fill, B, rcap)


def build_qoi_expand_fn(plan: QoiRecordPlan, mesh=None):
    """jit fn(cols [B,rcap] u32, cnts [B,rcap] u8, fill [B] u32) ->
    rgba [B,H,W,4] uint8: per-image count cumsum + one searchsorted
    run-length expansion (the assembly stage of the speculative path,
    fed by exact host records instead of a device record scan)."""
    import jax
    import jax.numpy as jnp

    npx = plan.width * plan.height
    bsh = None
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        bsh = NamedSharding(mesh, P("batch"))

    def _b(x):
        if bsh is None:
            return x
        return jax.lax.with_sharding_constraint(x, bsh)

    def expand_one(cum_b, cols_b, total_b, fill_b):
        gpix = jnp.arange(npx)
        op = jnp.searchsorted(cum_b, gpix, side="right")
        c = cols_b[jnp.clip(op, 0, cols_b.shape[0] - 1)]
        return jnp.where(gpix < total_b, c, fill_b)

    def fn(cols, cnts, fill):
        cum = jnp.cumsum(cnts.astype(jnp.int32), axis=1)
        total = cum[:, -1]
        cum, cols, total, fill = _b(cum), _b(cols), _b(total), _b(fill)
        packed = jax.vmap(expand_one)(cum, cols, total, fill)
        rgba = jnp.stack(
            [
                (packed >> 24).astype(jnp.uint8),
                ((packed >> 16) & 0xFF).astype(jnp.uint8),
                ((packed >> 8) & 0xFF).astype(jnp.uint8),
                (packed & 0xFF).astype(jnp.uint8),
            ],
            axis=-1,
        ).reshape(cols.shape[0], plan.height, plan.width, 4)
        return _b(rgba)

    return jax.jit(fn)


@dataclass
class QoiLanePlan:
    """Lane-aligned host record pass (the gather-free expansion format).

    The raster is cut into P-pixel lanes; every record is split at lane
    boundaries into (color, local start, local end) entries.  Host
    arrays are lane-MAJOR [Lt, R] (Lt = batch * lanes-per-image, lanes
    batch-major; each lane's R slots contiguous so the C++ fill streams
    sequentially); the device graph transposes once on-chip to its
    lanes-minor [R, Lt] compute form.  R = bucketed max entries/lane."""

    width: int
    height: int
    P: int
    cols: np.ndarray  # [Lt, R] uint32 (fmt="wide"; None for "p4")
    s: np.ndarray  # [Lt, R] int16 local start (>= e means empty slot)
    e: np.ndarray  # [Lt, R] int16 local end
    batch: int
    R: int
    # fmt="p4" (round-5 upload trim): entries are (r, g, b, start) u8
    # granules in ONE [Lt, R*4] array — half the wide form's bytes on
    # ~1-entry/px content.  Ends are implicit (e[r] = s[r+1], last = P;
    # pad slots carry the sentinel s = P).  Opaque streams with
    # P <= 255 only; prep_qoi_lanes4 returns None otherwise.
    fmt: str = "wide"
    p4: np.ndarray | None = None


def _lane_scan_py(data: bytes, npx: int, P: int):
    """Pure-Python twin of zpix_qoi_lane_scan: derive lane entries from
    the Python record scan (ZPIX_NATIVE=0 path)."""
    if P <= 0 or P > 32767:  # native rc=4: entries are int16 local spans
        raise UnsupportedError(f"qoi: lane_p {P} outside int16 span range")
    cols, cnts, fill = _record_scan_py(data, npx)
    ends = np.cumsum(cnts.astype(np.int64))
    starts = ends - cnts
    total = int(ends[-1]) if len(ends) else 0
    if total < npx:  # stream-exhausted tail as ordinary fill entries
        cols = np.append(cols, np.uint32(fill))
        starts = np.append(starts, total)
        ends = np.append(ends, npx)
    first_lane = starts // P
    last_lane = (ends - 1) // P
    spans = (last_lane - first_lane + 1).astype(np.int64)
    m = int(spans.sum())
    rid = np.repeat(np.arange(len(cols)), spans)
    ofs = np.arange(m) - np.repeat(np.cumsum(spans) - spans, spans)
    lane = first_lane[rid] + ofs
    ls = np.maximum(starts[rid] - lane * P, 0).astype(np.int16)
    le = np.minimum(ends[rid] - lane * P, P).astype(np.int16)
    return cols[rid], ls, le, lane.astype(np.int64)


def _lane_scan_native(data: bytes, npx: int, P: int):
    import ctypes

    from .. import runtime

    lib = runtime.get_lib()
    n_lanes = -(-npx // P)
    ecap = max(1, len(data)) + n_lanes + 1
    cols = np.empty(ecap, np.uint32)
    s = np.empty(ecap, np.int16)
    e = np.empty(ecap, np.int16)
    lane_cnt = np.zeros(n_lanes, np.int32)
    m_out = ctypes.c_int64()
    fill = ctypes.c_uint32()
    rc = lib.zpix_qoi_lane_scan(
        data, len(data), npx, P,
        cols.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        s.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        e.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        ecap,
        lane_cnt.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n_lanes, ctypes.byref(m_out), ctypes.byref(fill),
    )
    if rc != 0:
        raise FormatError(f"qoi: lane scan failed (rc={rc})")
    m = m_out.value
    # entries are emitted lane-ordered (sequential decode), so the lane
    # index of entry i recovers from the per-lane counts without a sort
    lane = np.repeat(np.arange(n_lanes, dtype=np.int64), lane_cnt)
    return cols[:m], s[:m], e[:m], lane


def _bucket8(r: int) -> int:
    return -(-max(r, 1) // 8) * 8


def prep_qoi_lanes(datas: list[bytes], P: int | None = None,
                   r_hint: int | None = None,
                   out: tuple | None = None) -> QoiLanePlan:
    """Lane-aligned host pass (threaded across the batch).  R buckets to
    the next multiple of 8 (>= r_hint) for shared compiled layouts.  The
    native path fills the padded [Lt, R] arrays in ONE sequential C++
    pass per image (zpix_qoi_lane_fill); an undersized R guess costs one
    extra refill pass.  `out`: optional (cols, s, e) arrays from a prior
    same-layout plan to fill in place — fresh 100+ MB allocations pay
    ~3x the fill time in first-touch page faults, so steady-state
    callers should double-buffer (the fill overwrites every slot, so
    reuse is exact)."""
    import ctypes
    import os as _os
    from concurrent.futures import ThreadPoolExecutor

    from .. import runtime

    if not datas:
        raise ValueError("qoi: empty batch")
    P = P or int(_os.environ.get("ZPIX_QOI_LANE_P", "32"))
    P = min(P, 32767)  # entries carry int16 local spans (native rc=4)
    w, h, _c, _cs = _parse_header(datas[0])
    npx = w * h
    for d in datas[1:]:
        w2, h2, _c2, _cs2 = _parse_header(d)
        if (w2, h2) != (w, h):
            raise UnsupportedError("qoi: mixed dimensions in batch")
    if npx % P:
        # lanes must tile the raster exactly (the graph reshapes
        # [Lt, P] -> [B, npx]): shrink to the largest divisor <= P
        P = next(q for q in range(min(P, npx), 0, -1) if npx % q == 0)
    n_lanes = npx // P
    B = len(datas)
    Lt = B * n_lanes

    lib = runtime.get_lib()
    native = lib is not None and hasattr(lib, "zpix_qoi_lane_fill")
    nthreads = min(B, _os.cpu_count() or 2)

    if not native:  # pure-Python fallback (ZPIX_NATIVE=0)
        with ThreadPoolExecutor(max_workers=nthreads) as ex:
            parts = list(ex.map(lambda d: _lane_scan_py(d, npx, P), datas))
        need = max(
            int(np.bincount(lane, minlength=n_lanes).max())
            for _c2, _s2, _e2, lane in parts
        )
        R = _bucket8(max(need, r_hint or 0))
        cols = np.zeros((Lt, R), np.uint32)
        s = np.ones((Lt, R), np.int16)  # s >= e: empty slot contributes 0
        e = np.zeros((Lt, R), np.int16)
        for i, (c, ls, le, lane) in enumerate(parts):
            cnt = np.bincount(lane, minlength=n_lanes)
            first = np.cumsum(cnt) - cnt
            slot = np.arange(len(c)) - first[lane]
            row = i * n_lanes + lane
            cols[row, slot] = c
            s[row, slot] = ls
            e[row, slot] = le
        return QoiLanePlan(w, h, P, cols, s, e, B, R)

    # initial R: the layout hint, or an avg-density estimate for the
    # probe pass (ops/lane ~= stream_bytes / 2.9 / n_lanes; x1.25 + 2
    # covers boundary splits; an undershoot just costs one refill pass)
    if r_hint:
        R = _bucket8(r_hint)
    else:
        est = max(len(d) for d in datas) / 2.9 / n_lanes
        R = _bucket8(int(est * 1.25) + 2)

    u32p = ctypes.POINTER(ctypes.c_uint32)
    i16p = ctypes.POINTER(ctypes.c_int16)

    while True:
        if out is not None and out[0].shape == (Lt, R):
            cols, s, e = out
        else:
            cols = np.empty((Lt, R), np.uint32)
            s = np.empty((Lt, R), np.int16)
            e = np.empty((Lt, R), np.int16)

        def fill(i):
            d = datas[i]
            off = i * n_lanes * R
            need = ctypes.c_int32()
            fillpx = ctypes.c_uint32()
            rc = lib.zpix_qoi_lane_fill(
                d, len(d), npx, P, R,
                ctypes.cast(cols.ctypes.data + 4 * off, u32p),
                ctypes.cast(s.ctypes.data + 2 * off, i16p),
                ctypes.cast(e.ctypes.data + 2 * off, i16p),
                ctypes.byref(need), ctypes.byref(fillpx),
            )
            if rc not in (0, 3):
                raise FormatError(f"qoi: lane fill failed (rc={rc})")
            return need.value

        with ThreadPoolExecutor(max_workers=nthreads) as ex:
            needs = list(ex.map(fill, range(B)))
        tight = _bucket8(max(max(needs), r_hint or 0))
        if max(needs) <= R:
            if tight < R and not r_hint:
                # estimate overshot: refill once at the tight bucket
                # (R is upload bytes AND device compute — worth one
                # extra ~100 ms pass on the first batch of a layout)
                out = None
                R = tight
                continue
            return QoiLanePlan(w, h, P, cols, s, e, B, R)
        R = tight


def prep_qoi_lanes4(datas: list[bytes], P: int | None = None,
                    r_hint: int | None = None,
                    out: np.ndarray | None = None) -> QoiLanePlan | None:
    """Packed-4-byte lane prep (round-5 upload trim): each entry is an
    (r, g, b, start) uint8 granule — 4 B/entry vs the wide form's 8 —
    with implicit ends (entries tile every lane contiguously, so
    e[r] = s[r+1] and the last real entry ends at P).  Applies to
    OPAQUE streams with P <= 255; returns None when the content needs
    the wide form (the caller falls back to prep_qoi_lanes).  `out`:
    optional [Lt, R*4] array from a prior same-layout plan to refill
    in place (same double-buffer rationale as prep_qoi_lanes)."""
    import ctypes
    import os as _os
    from concurrent.futures import ThreadPoolExecutor

    from .. import runtime

    if not datas:
        raise ValueError("qoi: empty batch")
    P = P or int(_os.environ.get("ZPIX_QOI_LANE_P", "32"))
    P = min(P, 255)  # starts are uint8; sentinel = P
    w, h, _c, _cs = _parse_header(datas[0])
    npx = w * h
    for d in datas[1:]:
        w2, h2, _c2, _cs2 = _parse_header(d)
        if (w2, h2) != (w, h):
            raise UnsupportedError("qoi: mixed dimensions in batch")
    if npx % P:
        P = next(q for q in range(min(P, npx), 0, -1) if npx % q == 0)
    n_lanes = npx // P
    B = len(datas)
    Lt = B * n_lanes

    lib = runtime.get_lib()
    nthreads = min(B, _os.cpu_count() or 2)

    if lib is None or not hasattr(lib, "zpix_qoi_lane_fill4"):
        # pure-Python fallback (ZPIX_NATIVE=0): derive from the record
        # scan, bail to the wide form on any non-opaque color
        with ThreadPoolExecutor(max_workers=nthreads) as ex:
            parts = list(ex.map(lambda d: _lane_scan_py(d, npx, P), datas))
        if any(
            not np.all((c & np.uint32(0xFF)) == 0xFF) for c, *_ in parts
        ):
            return None
        need = max(
            int(np.bincount(lane, minlength=n_lanes).max())
            for _c2, _s2, _e2, lane in parts
        )
        R = _bucket8(max(need, r_hint or 0))
        p4 = np.zeros((Lt, R, 4), np.uint8)
        p4[:, :, 3] = P  # sentinel
        for i, (c, ls, _le, lane) in enumerate(parts):
            cnt = np.bincount(lane, minlength=n_lanes)
            first = np.cumsum(cnt) - cnt
            slot = np.arange(len(c)) - first[lane]
            row = i * n_lanes + lane
            p4[row, slot, 0] = (c >> 24).astype(np.uint8)
            p4[row, slot, 1] = ((c >> 16) & 0xFF).astype(np.uint8)
            p4[row, slot, 2] = ((c >> 8) & 0xFF).astype(np.uint8)
            p4[row, slot, 3] = ls.astype(np.uint8)
        return QoiLanePlan(w, h, P, None, None, None, B, R,
                           fmt="p4", p4=p4.reshape(Lt, R * 4))

    if r_hint:
        R = _bucket8(r_hint)
    else:
        est = max(len(d) for d in datas) / 2.9 / n_lanes
        R = _bucket8(int(est * 1.25) + 2)

    u8p = ctypes.POINTER(ctypes.c_uint8)
    bail = [False]
    while True:
        if out is not None and out.shape == (Lt, R * 4):
            p4 = out
        else:
            p4 = np.empty((Lt, R * 4), np.uint8)

        def fill(i):
            d = datas[i]
            off = i * n_lanes * R * 4
            need = ctypes.c_int32()
            fillpx = ctypes.c_uint32()
            rc = lib.zpix_qoi_lane_fill4(
                d, len(d), npx, P, R,
                ctypes.cast(p4.ctypes.data + off, u8p),
                ctypes.byref(need), ctypes.byref(fillpx),
            )
            if rc == 5:  # non-opaque: wide-form content
                bail[0] = True
                return 0
            if rc not in (0, 3):
                raise FormatError(f"qoi: lane fill4 failed (rc={rc})")
            return need.value

        with ThreadPoolExecutor(max_workers=nthreads) as ex:
            needs = list(ex.map(fill, range(B)))
        if bail[0]:
            return None
        tight = _bucket8(max(max(needs), r_hint or 0))
        if max(needs) <= R:
            if tight < R and not r_hint:
                out = None
                R = tight
                continue
            return QoiLanePlan(w, h, P, None, None, None, B, R,
                               fmt="p4", p4=p4)
        R = tight


def build_qoi_lane_expand_fn(plan: QoiLanePlan, mesh=None):
    """jit fn(cols [Lt,R] u32, s [Lt,R] i16, e [Lt,R] i16) -> rgba
    [B,H,W,4] uint8 — gather-free run expansion: each lane's P pixels
    are a masked sum over its R entry slots (out[p, lane] =
    sum_r col[r] * (s[r] <= p < e[r])), elementwise compare/select.  The
    host ships lane-MAJOR arrays (sequential C++ fill); the graph's
    first op transposes them to the lanes-minor [R, Lt] compute form
    (the layout rule: the huge lane axis stays minor in every hot op)."""
    import jax
    import jax.numpy as jnp

    P, R, B = plan.P, plan.R, plan.batch
    npx = plan.width * plan.height
    shrow = None
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as PS

        shrow = NamedSharding(mesh, PS("batch"))  # [Lt, R]: lanes batch-major
        shcol = NamedSharding(mesh, PS(None, "batch"))

    if plan.fmt == "p4":
        # packed (r, g, b, start) granules: rebuild the u32 colors and
        # the implicit ends (e[r] = s[r+1], last = P) on device — a few
        # cheap [R, Lt] elementwise ops buy half the staged bytes
        def fn4(p4_lr):
            if shrow is not None:
                p4_lr = jax.lax.with_sharding_constraint(p4_lr, shrow)
            t = jnp.transpose(
                p4_lr.reshape(p4_lr.shape[0], R, 4), (1, 2, 0)
            )  # [R, 4, Lt] lanes minor
            if shrow is not None:
                t = jax.lax.with_sharding_constraint(
                    t, NamedSharding(mesh, PS(None, None, "batch"))
                )
            u32 = jnp.uint32
            cols = (
                (t[:, 0].astype(u32) << 24)
                | (t[:, 1].astype(u32) << 16)
                | (t[:, 2].astype(u32) << 8)
                | u32(0xFF)
            )  # [R, Lt]
            s = t[:, 3].astype(jnp.int16)
            e = jnp.concatenate(
                [s[1:], jnp.full((1, s.shape[1]), P, jnp.int16)], axis=0
            )
            return _expand(cols, s, e)

        def _expand(cols, s, e):
            p = jnp.arange(P, dtype=jnp.int16)
            m = (p[None, :, None] >= s[:, None, :]) & (
                p[None, :, None] < e[:, None, :]
            )
            out = jnp.sum(
                jnp.where(m, cols[:, None, :], jnp.uint32(0)),
                axis=0, dtype=jnp.uint32,
            )
            if shrow is not None:
                out = jax.lax.with_sharding_constraint(out, shcol)
            packed = out.T.reshape(B, npx)
            rgba = jnp.stack(
                [
                    (packed >> 24).astype(jnp.uint8),
                    ((packed >> 16) & 0xFF).astype(jnp.uint8),
                    ((packed >> 8) & 0xFF).astype(jnp.uint8),
                    (packed & 0xFF).astype(jnp.uint8),
                ],
                axis=-1,
            ).reshape(B, plan.height, plan.width, 4)
            if mesh is not None:
                from jax.sharding import NamedSharding as NS

                rgba = jax.lax.with_sharding_constraint(
                    rgba, NS(mesh, PS("batch"))
                )
            return rgba

        return jax.jit(fn4)

    def fn(cols_lr, s_lr, e_lr):
        if shrow is not None:
            cols_lr = jax.lax.with_sharding_constraint(cols_lr, shrow)
            s_lr = jax.lax.with_sharding_constraint(s_lr, shrow)
            e_lr = jax.lax.with_sharding_constraint(e_lr, shrow)
        cols, s, e = cols_lr.T, s_lr.T, e_lr.T  # -> [R, Lt] lanes minor
        if shrow is not None:
            cols = jax.lax.with_sharding_constraint(cols, shcol)
            s = jax.lax.with_sharding_constraint(s, shcol)
            e = jax.lax.with_sharding_constraint(e, shcol)
        p = jnp.arange(P, dtype=jnp.int16)  # [P]
        if os.environ.get("ZPIX_QOI_EXPAND_FORM", "sum") == "sum":
            # one fused reduction over R: XLA fuses the broadcast
            # compare/select into the reduce, so inputs stream once
            # (an explicit out += loop round-trips the [P, Lt]
            # accumulator through device memory per slot)
            m = (p[None, :, None] >= s[:, None, :]) & (
                p[None, :, None] < e[:, None, :]
            )  # [R, P, Lt]
            out = jnp.sum(
                jnp.where(m, cols[:, None, :], jnp.uint32(0)),
                axis=0, dtype=jnp.uint32,
            )
        else:  # loop form (A/B reference)
            out = jnp.zeros((P, cols.shape[1]), jnp.uint32)
            for r in range(R):  # static unroll: R is layout-bucketed
                m = (p[:, None] >= s[r][None, :]) & (
                    p[:, None] < e[r][None, :]
                )
                out = out + jnp.where(m, cols[r][None, :], jnp.uint32(0))
        if shrow is not None:
            out = jax.lax.with_sharding_constraint(out, shcol)
        packed = out.T.reshape(B, npx)  # [Lt, P] rows are lanes in order
        rgba = jnp.stack(
            [
                (packed >> 24).astype(jnp.uint8),
                ((packed >> 16) & 0xFF).astype(jnp.uint8),
                ((packed >> 8) & 0xFF).astype(jnp.uint8),
                (packed & 0xFF).astype(jnp.uint8),
            ],
            axis=-1,
        ).reshape(B, plan.height, plan.width, 4)
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as PS

            rgba = jax.lax.with_sharding_constraint(
                rgba, NamedSharding(mesh, PS("batch"))
            )
        return rgba

    return jax.jit(fn)


class HostIndexQoiDecoder:
    """QOI decode via host C++ record pass + device run-length expansion.

    The production fast path for QOI batches (the speculative chip
    scan remains the full-chip-residency option — see the section
    comment above for the measured convergence wall).  decode() returns
    a device [B, H, W, 4] uint8 raster; exactness is by construction
    (the host pass IS the serial reference semantics), so there is no
    ok flag.

    impl="lane" (default): gather-free compare-mask expansion over
    P-pixel lanes (build_qoi_lane_expand_fn) — jnp.searchsorted is
    gather-bound; the lane form is elementwise compare/select.
    impl="sorted" keeps the searchsorted graph
    (fine on CPU, and a useful differential).  lane_p: pixels per lane
    (must divide width*height); smaller P cuts device compute on
    dense-op content, larger P cuts upload bytes on run-heavy content.

    lane_fmt="auto" (default): opaque batches with P <= 255 stage
    packed (r, g, b, start) u8 granules — HALF the wide form's bytes
    over the link (prep_qoi_lanes4) — with automatic per-batch
    fallback to the wide (col u32 + s/e i16) form on alpha content.
    "wide"/"p4" pin the format."""

    def __init__(self, *, mesh=None, impl: str = "lane",
                 lane_p: int | None = None, lane_fmt: str = "auto"):
        self.mesh = mesh
        self.impl = impl
        self.lane_p = lane_p
        self.lane_fmt = lane_fmt
        self._fns: dict = {}
        self._rcap_hint = 0
        self._r_hint = 0
        self._r4_hint = 0

    def decode(self, datas: list[bytes],
               plan: "QoiRecordPlan | QoiLanePlan | None" = None):
        import jax

        from ..utils import metrics, trace

        if self.impl == "lane":
            with trace("qoi_hostindex.prep"):
                if plan is None and self.lane_fmt in ("auto", "p4"):
                    plan = prep_qoi_lanes4(datas, self.lane_p,
                                           self._r4_hint or None)
                    if plan is None and self.lane_fmt == "p4":
                        raise UnsupportedError(
                            "qoi: lane_fmt='p4' needs opaque content "
                            "(alpha in stream) — use 'auto' or 'wide'"
                        )
                if plan is None:
                    plan = prep_qoi_lanes(datas, self.lane_p,
                                          self._r_hint or None)
            metrics.count("qoi_hostindex.images", plan.batch)
            key = ("lane", plan.fmt, plan.width, plan.height, plan.batch,
                   plan.P, plan.R)
            fn = self._fns.get(key)
            if fn is None:
                fn = build_qoi_lane_expand_fn(plan, mesh=self.mesh)
                self._fns[key] = fn
            put = self._put
            if plan.fmt == "p4":
                self._r4_hint = max(self._r4_hint, plan.R)
                return fn(put(plan.p4))
            self._r_hint = max(self._r_hint, plan.R)
            return fn(put(plan.cols), put(plan.s), put(plan.e))

        with trace("qoi_hostindex.prep"):
            if plan is None:
                plan = prep_qoi_records(datas, self._rcap_hint or None)
        self._rcap_hint = max(self._rcap_hint, plan.rcap)
        metrics.count("qoi_hostindex.images", plan.batch)
        key = ("sorted", plan.width, plan.height, plan.batch, plan.rcap)
        fn = self._fns.get(key)
        if fn is None:
            fn = build_qoi_expand_fn(plan, mesh=self.mesh)
            self._fns[key] = fn
        if self.mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            bsh = NamedSharding(self.mesh, P("batch"))
            return fn(
                jax.device_put(plan.cols, bsh),
                jax.device_put(plan.cnts, bsh),
                jax.device_put(plan.fill, bsh),
            )
        return fn(
            jax.device_put(plan.cols),
            jax.device_put(plan.cnts),
            jax.device_put(plan.fill),
        )

    def _put(self, arr):
        import jax

        if self.mesh is None:
            return jax.device_put(arr)
        from jax.sharding import NamedSharding, PartitionSpec as P

        # lane-major [Lt, R]: lanes are batch-major, shard the lane axis
        return jax.device_put(
            arr, NamedSharding(self.mesh, P("batch"))
        )


# ---------------------------------------------------------------------------
# On-device QOI ENCODE — the jnp twin of codecs/qoi/encode_vec.py.
#
# Same derivation (see that module's docstring for the proofs): runs are
# shifted compares, INDEX hits reduce to "equals the previous literal in
# my hash bucket" (one stable sort), DIFF/LUMA are elementwise, and the
# byte stream assembles by cumsum offsets + masked drop-mode scatters.
# Reference op semantics: /root/reference/src/qoi/encoder.zig:29-132.
# ---------------------------------------------------------------------------


def _encode_core(px, cap: int):
    """px: [n] uint32 packed 0xRRGGBBAA -> (out [cap+1] uint8, total i32).

    out[:total] are exactly the op-stream bytes the serial encoder emits
    (no header/padding).  Masked scatter lanes index past the buffer and
    are dropped: pointing them all at one in-bounds slot serializes the
    scatter on that address on the GPU.
    """
    import jax
    import jax.numpy as jnp

    i32, u32, u8 = jnp.int32, jnp.uint32, jnp.uint8
    n = px.shape[0]
    prev = jnp.concatenate([jnp.array([0x000000FF], u32), px[:-1]])
    is_run = px == prev
    lit = ~is_run

    r = (px >> 24).astype(i32)
    g = ((px >> 16) & 0xFF).astype(i32)
    b = ((px >> 8) & 0xFF).astype(i32)
    a = (px & 0xFF).astype(i32)
    pr = (prev >> 24).astype(i32)
    pg = ((prev >> 16) & 0xFF).astype(i32)
    pb = ((prev >> 8) & 0xFF).astype(i32)
    pa = (prev & 0xFF).astype(i32)
    h = (r * 3 + g * 5 + b * 7 + a * 11) & 63

    # INDEX hit: previous literal in the same hash bucket equals me
    # (bucket's first literal compares against the zero-initialized
    # table).  Run members sort to a sentinel bucket past every real one.
    key = jnp.where(lit, h, 64)
    order = jnp.argsort(key, stable=True)
    sh = key[order]
    sv = px[order]
    prev_v = jnp.concatenate([jnp.zeros(1, u32), sv[:-1]])
    same_bucket = jnp.concatenate(
        [jnp.zeros(1, bool), sh[1:] == sh[:-1]]
    )
    bucket_prev = jnp.where(same_bucket, prev_v, u32(0))
    hit_sorted = (bucket_prev == sv) & (sh < 64)
    hit = jnp.zeros(n, bool).at[order].set(hit_sorted)

    vr = r - pr
    vg = g - pg
    vb = b - pb
    vg_r = vr - vg
    vg_b = vb - vg
    same_a = a == pa
    can_diff = (
        same_a
        & (-3 < vr) & (vr < 2)
        & (-3 < vg) & (vg < 2)
        & (-3 < vb) & (vb < 2)
    )
    can_luma = (
        same_a
        & (-9 < vg_r) & (vg_r < 8)
        & (-33 < vg) & (vg < 32)
        & (-9 < vg_b) & (vg_b < 8)
    )

    miss = lit & ~hit
    kind = jnp.zeros(n, jnp.int8)
    kind = jnp.where(lit & hit, 1, kind)
    kind = jnp.where(miss & can_diff, 2, kind)
    kind = jnp.where(miss & ~can_diff & can_luma, 3, kind)
    kind = jnp.where(miss & ~can_diff & ~can_luma & same_a, 4, kind)
    kind = jnp.where(miss & ~can_diff & ~can_luma & ~same_a, 5, kind)

    # Run bookkeeping: position within each maximal run segment via a
    # cummax over segment-start indices (encoder.zig's `run` counter).
    iarr = jnp.arange(n, dtype=i32)
    run_start = is_run & jnp.concatenate([jnp.ones(1, bool), ~is_run[:-1]])
    seg_start = jax.lax.cummax(jnp.where(run_start, iarr, i32(-1)))
    pos_in_seg = jnp.where(is_run, iarr - seg_start + 1, 0)
    flush62 = is_run & (pos_in_seg % 62 == 0)  # RUN(62) at 62-boundaries
    prev_runlen = jnp.concatenate([jnp.zeros(1, i32), pos_in_seg[:-1]])
    prev_isrun = jnp.concatenate([jnp.zeros(1, bool), is_run[:-1]])
    run_before = jnp.where(lit & prev_isrun, prev_runlen % 62, 0)
    tail_flush = jnp.where(is_run[-1], pos_in_seg[-1] % 62, 0)

    sizes = jnp.array([0, 1, 1, 2, 4, 5], i32)[kind.astype(i32)]
    sizes = sizes + flush62.astype(i32) + (run_before > 0).astype(i32)
    offs = jnp.cumsum(sizes) - sizes
    total = offs[-1] + sizes[-1]

    out = jnp.zeros(cap + 1, u8)

    def put(buf, idx, val, mask):
        return buf.at[jnp.where(mask, idx, cap + 1)].set(
            val.astype(u8), mode="drop"
        )

    out = put(out, offs, jnp.full(n, 0xC0 | 61, i32), flush62)
    out = put(out, offs, 0xC0 | (run_before - 1), run_before > 0)
    lo = offs + (run_before > 0)  # literal bytes follow the flush byte
    k = kind
    out = put(out, lo, h, k == 1)
    out = put(
        out, lo, 0x40 | ((vr + 2) << 4) | ((vg + 2) << 2) | (vb + 2), k == 2
    )
    out = put(out, lo, 0x80 | (vg + 32), k == 3)
    out = put(out, lo + 1, ((vg_r + 8) << 4) | (vg_b + 8), k == 3)
    out = put(out, lo, jnp.full(n, 0xFE, i32), k == 4)
    is45 = (k == 4) | (k == 5)
    out = put(out, lo + 1, r, is45)
    out = put(out, lo + 2, g, is45)
    out = put(out, lo + 3, b, is45)
    out = put(out, lo, jnp.full(n, 0xFF, i32), k == 5)
    out = put(out, lo + 4, a, k == 5)
    # end-of-stream residual run flush (encoder.zig's i == n-1 emission)
    out = out.at[jnp.where(tail_flush > 0, total, cap + 1)].set(
        (0xC0 | (tail_flush - 1)).astype(u8), mode="drop"
    )
    return out, total + (tail_flush > 0).astype(i32)


_ENC_FNS: dict = {}


def _encode_fn(n: int, batched: bool):
    key = (n, batched)
    fn = _ENC_FNS.get(key)
    if fn is None:
        import jax

        cap = 5 * n + n // 62 + 8
        core = lambda px: _encode_core(px, cap)  # noqa: E731
        fn = jax.jit(jax.vmap(core) if batched else core)
        _ENC_FNS[key] = fn
    return fn


def _pack_px(pixels, desc) -> np.ndarray:
    n = desc.width * desc.height
    pix = np.asarray(pixels, np.uint8).reshape(-1)
    from ..errors import FormatError as FE

    if len(pix) < n * desc.channels:
        raise FE("qoi: pixel buffer too small")
    c = pix[: n * desc.channels].reshape(n, desc.channels).astype(np.uint32)
    a = c[:, 3] if desc.channels == 4 else np.full(n, 255, np.uint32)
    return (c[:, 0] << 24) | (c[:, 1] << 16) | (c[:, 2] << 8) | a


def encode_device(pixels, desc) -> bytes:
    """On-device QOI encode: byte-identical to codecs/qoi/encode.encode().

    The op planning and byte assembly run as one jitted graph on the
    default backend; the host only packs input pixels and prepends the
    header / appends the 8-byte padding.
    """
    import struct

    from ..codecs.qoi.decode import QOI_PIXELS_MAX
    from ..errors import FormatError as FE

    if (
        desc.width == 0
        or desc.height == 0
        or desc.channels not in (3, 4)
        or desc.colorspace > 1
        or desc.height >= QOI_PIXELS_MAX // desc.width
    ):
        raise FE("qoi: bad encode descriptor")
    px = _pack_px(pixels, desc)
    out, total = _encode_fn(px.shape[0], batched=False)(px)
    header = struct.pack(
        ">IIIBB", 0x716F6966, desc.width, desc.height, desc.channels,
        desc.colorspace,
    )
    return header + np.asarray(out)[: int(total)].tobytes() + (
        b"\x00" * 7 + b"\x01"
    )


def encode_device_batch(pixel_batch, descs) -> list[bytes]:
    """Batched on-device encode: one vmapped graph over same-size images.

    pixel_batch: [B, ...] uint8; descs: per-image Desc sharing
    width/height/channels.  Returns the per-image encoded bytes."""
    import struct

    d0 = descs[0]
    if any(
        (d.width, d.height, d.channels) != (d0.width, d0.height, d0.channels)
        for d in descs
    ):
        raise UnsupportedError("qoi: encode batch must share geometry")
    px = np.stack([_pack_px(p, d) for p, d in zip(pixel_batch, descs)])
    outs, totals = _encode_fn(px.shape[1], batched=True)(px)
    outs = np.asarray(outs)
    totals = np.asarray(totals)
    res = []
    for i, d in enumerate(descs):
        header = struct.pack(
            ">IIIBB", 0x716F6966, d.width, d.height, d.channels, d.colorspace
        )
        res.append(
            header + outs[i, : int(totals[i])].tobytes() + b"\x00" * 7 + b"\x01"
        )
    return res
