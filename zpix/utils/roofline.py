"""Analytic roofline accounting for the on-device JPEG decode stages.

Bytes moved and int32 operations issued per stage, from the ScanPlan's
static shapes and the measured while-loop trip counts, compared with the
card's published peaks.  The op counts are analytic ESTIMATES (counted
from the kernel structure, not the compiled HLO), good to about +-30%:
enough to say whether a stage is bandwidth- or issue-bound, and by how
far.  The decode is integer-exact and never touches the tensor cores, so
the compute peak is the int32 issue rate of the CUDA cores.

Peaks are keyed by the exact ``jax.Device.device_kind``.  A device that is
not in the table gets no peak and no share.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Peaks:
    hbm_gbs: float  # device-memory bandwidth, GB/s
    int32_tops: float  # int32 operations issued per second, 1e12
    source: str


PEAKS = {
    # H100 SXM5.  HBM3 3.35 TB/s: NVIDIA H100 data sheet.  int32: 132 SMs
    # x 64 int32 lanes per SM (4 partitions x 16, Hopper white paper) x
    # 1.98 GHz boost clock = 16.7 Tops/s.  Both assume the 700 W limit.
    "NVIDIA H100 80GB HBM3": Peaks(
        3350.0, 132 * 64 * 1.98e9 / 1e12,
        "NVIDIA H100 data sheet (SXM5) and Hopper white paper",
    ),
}


def peaks_for(device_kind: str) -> Peaks | None:
    return PEAKS.get(device_kind)


@dataclass
class StageCost:
    name: str
    bytes_moved: float  # device-memory traffic, bytes per batch
    int_ops: float  # elementwise int32 ops per batch

    def line(self, ms: float | None, peaks: Peaks | None = None) -> str:
        if not ms:
            return (
                f"{self.name:<22} {self.bytes_moved/1e6:9.1f} MB "
                f"{self.int_ops/1e9:8.2f} Gop   (no time measured)"
            )
        bw = self.bytes_moved / (ms * 1e-3) / 1e9
        ops = self.int_ops / (ms * 1e-3) / 1e12
        if peaks is None:
            return (f"{self.name:<22} {ms:7.2f} ms  {bw:7.1f} GB/s  "
                    f"{ops:5.2f} Tops/s")
        return (
            f"{self.name:<22} {ms:7.2f} ms  "
            f"{bw:7.1f} GB/s ({100*bw/peaks.hbm_gbs:4.1f}% HBM)  "
            f"{ops:5.2f} Tops/s ({100*ops/peaks.int32_tops:4.1f}% INT32)"
        )


def _sym_decode_ops(cmp, active_tabs: int | None = None) -> float:
    """Per-lane-per-symbol op estimate for the gather-free canonical
    decode (_make_sym_decoder): 15 compare+2 accum per active table,
    8 bit-planes x word-range selects, plus look16/extend overhead."""
    ntab = active_tabs if active_tabs is not None else cmp.ntab
    nw = max(1, cmp.nwords)
    return 15 * 3 * ntab + 8 * (nw + 1) * 2 + 60


def jpeg_onchip_costs(plan, *, k_syms: int, k1_syms: int, w_words: int,
                      w1_words: int, steps1: int, steps2: int,
                      i16: bool = True, p1_i16: bool = False):
    """StageCosts for (pass1, pass2, back-end) of one batch decode.

    steps1/steps2: measured (or bounded) while-loop trip counts — the
    loops' traffic is carry-size x trips, which static shapes alone
    cannot give.
    """
    B = plan.batch
    L1 = B * plan.n_segs
    nblk = plan.seg_mcus * plan.bpm
    L2 = L1 * nblk
    cmp = plan.cmp

    # ---- pass 1: index pass, one lane per restart segment
    esz = 2 if p1_i16 else 4
    carry1 = L1 * (6 * 4 + 2 * 1) + nblk * L1 * esz
    win1 = L1 * w1_words * 4  # one [L1, W1] row gather per step
    bytes1 = steps1 * (2 * carry1 + win1)
    ops_sym1 = _sym_decode_ops(cmp) + 45  # + run/size/advance bookkeeping
    ops1 = steps1 * (L1 * k1_syms * ops_sym1 + k1_syms * nblk * L1 * 2)

    # ---- pass 2: value pass, one lane per block
    acsz = 2 if i16 else 4
    carry2 = L2 * (4 * 4 + 2 * 1) + 64 * L2 * acsz + (4 * L2 if i16 else 0)
    win2 = L2 * w_words * 4
    bytes2 = steps2 * (2 * carry2 + win2)
    # AC-only decode touches fewer tables; extend adds ~25 ops
    ops_sym2 = _sym_decode_ops(cmp, active_tabs=max(1, cmp.ntab // 2)) + 70
    ops2 = steps2 * (L2 * k_syms * ops_sym2 + k_syms * 64 * L2 * 2)

    # ---- SoA back-end: dequant + Wang IDCT + planes + upsample + color
    px = B * plan.height * plan.width
    sub = sum(h * v for h, v in plan.hv) / (plan.hv[0][0] * plan.hv[0][1])
    bytes3 = (
        64 * L2 * acsz  # coefficient store read
        + (4 * L2 if i16 else 0)  # DC row
        + 64 * L2 * 1  # uint8 pixel store write (pre-raster)
        + 64 * L2 * 1 * 2  # raster relayout read+write
        + px * sub  # plane reads for upsample/color
        + px * 3  # RGB store
    )
    # Wang butterfly ~29 ops per 8-vector x 2 passes x 8 rows/cols
    # ~= 58 ops per coefficient position, + dequant/clamp ~4, + ~12/px
    # upsample + exact color math
    ops3 = 64 * L2 * (58 + 4) + px * 12
    return (
        StageCost("pass1 (index)", bytes1, ops1),
        StageCost("pass2 (values)", bytes2, ops2),
        StageCost("back-end (IDCT+color)", bytes3, ops3),
    )


def report(costs, times_ms, device_kind: str,
           total_ms: float | None = None):
    """Text block: one utilization line per stage + the aggregate."""
    peaks = peaks_for(device_kind)
    if peaks is None:
        lines = [f"roofline: no peak known for {device_kind!r}; "
                 "no share computed"]
    else:
        lines = [f"roofline ({device_kind}: {peaks.hbm_gbs:.0f} GB/s HBM, "
                 f"{peaks.int32_tops:.1f} Tops/s INT32, {peaks.source}; "
                 "analytic op counts, +-30%)"]
    for c, ms in zip(costs, times_ms):
        lines.append("  " + c.line(ms, peaks))
    if total_ms:
        tb = sum(c.bytes_moved for c in costs)
        to = sum(c.int_ops for c in costs)
        lines.append(
            "  " + StageCost("TOTAL (fused)", tb, to).line(total_ms, peaks)
        )
    return "\n".join(lines)
