#!/usr/bin/env python3
"""Interleaved in-process A/B benchmark for on-device JPEG decode variants.

Times every variant inside ONE process, alternating per trial (order
flipped each trial), so all variants see the same card, clocks and
neighbours; reports best and median per variant.  Inputs are the
committed 1024² restart-interval JPEGs (testdata/), cycled to fill the
batch; every timing ends in block_until_ready and every ok flag must be
True.

    AB_VARIANTS=bar,nobar python tools/ab_bench.py

Env: AB_VARIANTS (comma list, see VARIANTS), AB_TRIALS (5), AB_STEPS
(12), BENCH_BATCH (16).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tools import corpus  # noqa: E402

VARIANTS = {
    # upload forms
    "packed": dict(packed=True),
    "3arg": dict(packed=False),
    # uploads hoisted out of the timed loop: isolates compute+dispatch
    "noup": dict(packed=True, _prefetch=True),
    # pass-2 window/unroll (prefetched: upload chaos swamps kernel deltas)
    "k16w6": dict(packed=True, k_syms=16, win_words=6, _prefetch=True),
    "k16w5": dict(packed=True, k_syms=16, win_words=5, _prefetch=True),
    "k8w4": dict(packed=True, k_syms=8, _prefetch=True),
    "k20w6": dict(packed=True, k_syms=20, win_words=6, _prefetch=True),
    "k24w8": dict(packed=True, k_syms=24, win_words=8, _prefetch=True),
    # pass-1 window/unroll
    "p1k24w8": dict(packed=True, k1_syms=24, win1_words=8, _prefetch=True),
    "p1k20w6": dict(packed=True, k1_syms=20, win1_words=6, _prefetch=True),
    "p1k32w10": dict(packed=True, k1_syms=32, win1_words=10, _prefetch=True),
    "p1k32w12": dict(packed=True, k1_syms=32, win1_words=12, _prefetch=True),
    "p1k48w16": dict(packed=True, k1_syms=48, win1_words=16, _prefetch=True),
    "p1k64w20": dict(packed=True, k1_syms=64, win1_words=20, _prefetch=True),
    "p1k40w12": dict(packed=True, k1_syms=40, win1_words=12, _prefetch=True),
    # one-IDCT + uint8-relayout back-end
    "mergedbk": dict(packed=True, _prefetch=True, merged_backend=True),
    # back-end layout: lane-minor SoA (default) vs per-component graphs
    "soabk": dict(packed=True, _prefetch=True, soa_backend=True),
    "percompbk": dict(packed=True, _prefetch=True, soa_backend=False),
    # window fetch: one [L, W] row gather vs W full-lane gathers (default)
    "rowgather": dict(packed=True, _prefetch=True, split_win=False),
    # output layout: planar [B,3,H,W] (minor W) vs interleaved [B,H,W,3]
    "planar": dict(packed=True, _prefetch=True, planar=True),
    # batch size (per-variant plans; default BENCH_BATCH)
    "b24": dict(packed=True, _prefetch=True, _batch=24),
    "b8planar": dict(packed=True, _prefetch=True, _batch=8, planar=True),
    "b12planar": dict(packed=True, _prefetch=True, _batch=12, planar=True),
    "b20planar": dict(packed=True, _prefetch=True, _batch=20, planar=True),
    "b32": dict(packed=True, _prefetch=True, _batch=32),
    "b32planar": dict(packed=True, _prefetch=True, _batch=32, planar=True),
    "planb16": dict(packed=True, _prefetch=True, planar=True),
    "k24w8planar": dict(packed=True, _prefetch=True, planar=True,
                        k_syms=24, win_words=8),
    "k32w10planar": dict(packed=True, _prefetch=True, planar=True,
                         k_syms=32, win_words=10),
    "k12w4planar": dict(packed=True, _prefetch=True, planar=True,
                        k_syms=12, win_words=4),
    # split16 value-pass store (int16 AC + int32 DC row)
    "i16planar": dict(packed=True, _prefetch=True, planar=True, i16=True),
    "p1i16planar": dict(packed=True, _prefetch=True, planar=True, p1_i16=True),
    "alli16planar": dict(packed=True, _prefetch=True, planar=True, i16=True,
                         p1_i16=True),
    # round 2 around the i16 winner: unroll width x restart interval x batch
    "i16k12planar": dict(packed=True, _prefetch=True, planar=True, i16=True,
                         k_syms=12, win_words=5),
    "i16k20planar": dict(packed=True, _prefetch=True, planar=True, i16=True,
                         k_syms=20, win_words=6),
    "i16k24planar": dict(packed=True, _prefetch=True, planar=True, i16=True,
                         k_syms=24, win_words=8),
    "i16b24planar": dict(packed=True, _prefetch=True, planar=True, i16=True,
                         _batch=24),
    "i16b32planar": dict(packed=True, _prefetch=True, planar=True, i16=True,
                         _batch=32),
    # round 4: pass-1 straggler bins (length-sorted lane groups) x batch
    "bins2planar": dict(packed=True, _prefetch=True, planar=True, bins=2),
    "bins4planar": dict(packed=True, _prefetch=True, planar=True, bins=4),
    "bins8planar": dict(packed=True, _prefetch=True, planar=True, bins=8),
    "b64planar": dict(packed=True, _prefetch=True, planar=True, _batch=64),
    "b32bins4planar": dict(packed=True, _prefetch=True, planar=True, bins=4,
                           _batch=32),
    "b64bins4planar": dict(packed=True, _prefetch=True, planar=True, bins=4,
                           _batch=64),
}


def main():
    import jax

    from zpix.parallel.device_entropy import DeviceJpegDecoder, prep_batch
    from zpix.utils.cache import enable_compile_cache

    enable_compile_cache()
    batch = int(os.environ.get("BENCH_BATCH", "16"))
    steps = int(os.environ.get("AB_STEPS", "12"))
    trials = int(os.environ.get("AB_TRIALS", "5"))
    names = os.environ.get("AB_VARIANTS", "packed,3arg").split(",")
    dev = jax.devices()[0]
    print(f"device {dev.platform} {dev.device_kind}")

    plans = {}
    setups = {}
    for name in names:
        cfg = dict(VARIANTS[name])
        prefetch = cfg.pop("_prefetch", False)
        vbatch = cfg.pop("_batch", batch)
        if vbatch not in plans:
            plans[vbatch] = prep_batch(corpus.large_batch("dri8", vbatch))
        plan = plans[vbatch]
        dec = DeviceJpegDecoder(**cfg)
        fused = dec._fused(plan)
        t0 = time.perf_counter()
        out, ok = jax.block_until_ready(fused(*dec._put(plan)))
        if not bool(ok):
            raise RuntimeError(f"{name}: decoder reported ok=False")
        print(f"{name}: compile+first {time.perf_counter() - t0:.1f}s",
              flush=True)
        setups[name] = (dec, fused, prefetch, plan, vbatch)

    results = {n: [] for n in names}
    for t in range(trials):
        order = names if t % 2 == 0 else names[::-1]
        for name in order:
            dec, fused, prefetch, plan, vbatch = setups[name]
            bufs = jax.block_until_ready(dec._put(plan)) if prefetch else None
            t1 = time.perf_counter()
            for _ in range(steps):
                out, ok = fused(*(bufs if prefetch else dec._put(plan)))
            jax.block_until_ready(out)
            dt = (time.perf_counter() - t1) / steps
            if not bool(ok):
                raise RuntimeError(f"{name}: decoder reported ok=False")
            results[name].append(dt)
            print(f"trial {t} {name}: {dt * 1e3:.2f} ms/step", flush=True)

    print("---- summary")
    for name in names:
        ts = sorted(results[name])
        best, med = ts[0], ts[len(ts) // 2]
        vm = setups[name][4] * corpus.LARGE_SIZE ** 2 / 1e6
        print(json.dumps({
            "variant": name, "device_kind": dev.device_kind,
            "best_ms": best * 1e3, "best_mpix_s": vm / best,
            "median_ms": med * 1e3, "median_mpix_s": vm / med,
            "trials_ms": [x * 1e3 for x in results[name]],
        }))


if __name__ == "__main__":
    main()
