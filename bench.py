#!/usr/bin/env python3
"""Benchmark: batched decode throughput on the device, MPix/s.

    python bench.py                         # restart-interval JPEG (onchip)
    BENCH_MODE=sync|prog|host|png|qoi python bench.py

Modes:
  onchip  restart-interval 4:2:0 JPEG, entropy decode on the device
          (DeviceJpegDecoder); inputs staged on the device, decode timed
  sync    restart-free JPEG: host index pass + device value pass
          (BENCH_SYNC_IMPL=spec: the speculative SyncJpegDecoder)
  prog    progressive JPEG (OnchipProgressiveDecoder, hostindex)
          (BENCH_PROG_IMPL=delta: DeviceProgressiveDecoder)
  host    JPEG with host entropy decode (BatchJpegDecoder, packed)
  png     RGB8 PNG; ZPIX_PNG_FRONT=host|defilter|inflate
  qoi     QOI; BENCH_QOI_CONTENT=noise|screen, BENCH_QOI_IMPL=hostindex|spec

JPEG inputs are the committed 1024x1024 images under testdata/ (4 distinct,
cycled to fill the batch); PNG and QOI inputs come from the seeded writers
of tools/corpus.py.  Every timing ends in block_until_ready, and every
decoder's ok flag must read True.

Prints one JSON line: {"metric", "value", "unit": "MPix/s", "device"}.
"""

import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

from tools import corpus  # noqa: E402


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def _check_ok(ok, what: str):
    if not bool(ok):
        raise RuntimeError(f"{what}: the decoder reported ok=False")


def _time_steps(run, steps: int, trials: int) -> list:
    """Per-step seconds of each trial: `run(i)` dispatches step i; each
    trial ends in block_until_ready on its last output."""
    import jax

    out = []
    for _ in range(trials):
        t0 = time.perf_counter()
        res = None
        for i in range(steps):
            res = run(i)
        jax.block_until_ready(res)
        out.append((time.perf_counter() - t0) / steps)
    return out


def jpeg_inputs(kind: str, batch: int, size: int) -> list:
    if size != corpus.LARGE_SIZE:
        raise SystemExit(f"bench: JPEG inputs are {corpus.LARGE_SIZE}² "
                         f"(testdata/); BENCH_SIZE={size}")
    return corpus.large_batch(kind, batch)


def _roofline_onchip(dec, plan0, bufs0):
    """Per-stage roofline lines: times the stage-truncated programs on one
    staged buffer, reads the while-loops' real trip counts, and prints
    achieved GB/s and Tops/s against the device's peaks (utils/roofline.py;
    no share for a device without a known peak)."""
    import jax

    from zpix.parallel import device_entropy as de
    from zpix.utils import roofline as rl

    kw = dict(
        k_syms=dec.k_syms, k1_syms=dec.k1_syms, win_words=dec.win_words,
        win1_words=dec.win1_words, packed=True, i16=dec.i16,
        p1_i16=dec.p1_i16, split_win=dec.split_win,
    )

    def timed(fn):
        jax.block_until_ready(fn(*bufs0))
        return _median(_time_steps(lambda i: fn(*bufs0), 4, 3)) * 1e3

    ms1 = timed(de.build_decode_fn(plan0, _stage=1, **kw))
    ms17 = timed(de.build_decode_fn(plan0, _stage=17, **kw))
    msf = timed(dec._fused(plan0))
    _, _, (s1, s2) = de.build_decode_fn(
        plan0, _soa_out=True, _stats=True, **kw
    )(*bufs0)
    steps1, steps2 = int(s1), int(s2)
    i16r = de._DEF_I16 if dec.i16 is None else bool(dec.i16)
    p1r = de._DEF_P1I16 if dec.p1_i16 is None else bool(dec.p1_i16)
    costs = rl.jpeg_onchip_costs(
        plan0,
        k_syms=dec.k_syms or de._DEF_K, k1_syms=dec.k1_syms or de._DEF_K1,
        w_words=dec.win_words or de._DEF_W,
        w1_words=dec.win1_words or de._DEF_W1,
        steps1=steps1, steps2=steps2, i16=i16r,
        p1_i16=p1r and (plan0.max_seg_bits + 512 < 32768),
    )
    times = [ms1, max(ms17 - ms1, 0.0), max(msf - ms17, 0.0)]
    print(f"# roofline trip counts: pass1 {steps1} steps, pass2 {steps2} "
          "steps", file=sys.stderr)
    kind = jax.devices()[0].device_kind
    for line in rl.report(costs, times, kind, total_ms=msf).splitlines():
        print(f"# {line}", file=sys.stderr)


def main_onchip(batch: int, size: int, steps: int, trials: int):
    """Restart-interval JPEG, entropy decode on the device.

    BENCH_STAGED=1 (default): `steps` copies of the packed buffer go to
    the device in ONE upload before the timed loop, which times the
    decode programs.  BENCH_STAGED=0: host prep overlapped with upload
    and decode through the pipeline, all timed.
    """
    import jax

    from zpix.parallel.device_entropy import DeviceJpegDecoder, prep_batch
    from zpix.parallel.pipeline import jpeg_onchip_pipeline

    datas = jpeg_inputs("dri8", batch, size)
    dec = DeviceJpegDecoder(planar=os.environ.get("BENCH_PLANAR", "1") == "1")
    plan0 = prep_batch(datas)
    fused = dec._fused(plan0)
    bufs0 = dec._put(plan0)
    t0 = time.perf_counter()
    _out, ok = fused(*bufs0)
    _check_ok(ok, "onchip warmup")
    print(f"# compile+first {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)

    if os.environ.get("BENCH_STAGED", "1") == "1":
        t_u = time.perf_counter()
        allb = jax.device_put(np.stack([plan0.packed] * steps))
        allb.block_until_ready()
        up_s = time.perf_counter() - t_u
        row = jax.jit(lambda a, i: fused(a[i]))
        jax.block_until_ready(row(allb, 0))
        oks = []

        def run(i):
            o, k = row(allb, i)
            oks.append(k)
            return o

        times = _time_steps(run, steps, trials)
        _check_ok(all(bool(k) for k in oks), "onchip")
        print(f"# staged upload {allb.nbytes / up_s / 1e6:.0f} MB/s "
              f"({plan0.packed.nbytes / (batch * size * size):.3f} B/px)",
              file=sys.stderr)
        if os.environ.get("BENCH_ROOFLINE", "1") == "1":
            _roofline_onchip(dec, plan0, bufs0)
    else:
        pipe = jpeg_onchip_pipeline(dec)
        times = []
        for _ in range(trials):
            t0 = time.perf_counter()
            res = list(pipe.map([datas] * steps))
            jax.block_until_ready(res)
            times.append((time.perf_counter() - t0) / steps)
            for _o, k in res:
                _check_ok(k, "onchip pipeline")
    print(f"# trials: {', '.join(f'{t * 1e3:.2f}' for t in times)} ms/step",
          file=sys.stderr)
    return batch * size * size / 1e6 / _median(times)


def _host_device_split(prep, run, datas, steps, trials, what):
    """Host pass and device pass timed apart, then overlapped (the host
    pass of step i+1 on a worker thread under the device pass of step i).
    Returns (host_s, device_s, overlapped_s) per batch."""
    import jax

    jax.block_until_ready(run(prep(datas)))
    t0 = time.perf_counter()
    plans = [prep(datas) for _ in range(steps)]
    host_s = (time.perf_counter() - t0) / steps
    dev_s = _median(_time_steps(lambda i: run(plans[i]), steps, trials))
    times = []
    with ThreadPoolExecutor(max_workers=1) as ex:
        for _ in range(trials):
            t0 = time.perf_counter()
            fut = ex.submit(prep, datas)
            res = None
            for _i in range(steps):
                p = fut.result()
                fut = ex.submit(prep, datas)
                res = run(p)
            jax.block_until_ready(res)
            fut.result()
            times.append((time.perf_counter() - t0) / steps)
    print(f"# {what}: host {host_s * 1e3:.2f} ms/batch, device "
          f"{dev_s * 1e3:.2f} ms/batch, overlapped "
          f"{_median(times) * 1e3:.2f} ms/batch", file=sys.stderr)
    return host_s, dev_s, _median(times)


def _e2e(call, mpix, steps, trials, what):
    """End-to-end rate of call() -> (out, ok) or out; ok must be True."""
    import jax

    def run(_i):
        r = call()
        if isinstance(r, tuple):
            _check_ok(r[1], what)
            return r[0]
        return r

    jax.block_until_ready(run(0))
    return mpix / _median(_time_steps(run, steps, trials))


def main_sync(batch: int, size: int, steps: int, trials: int):
    """Restart-free JPEG: host index pass + device value pass (default),
    or BENCH_SYNC_IMPL=spec, the speculative SyncJpegDecoder."""
    datas = jpeg_inputs("plain", batch, size)
    mpix = batch * size * size / 1e6
    if os.environ.get("BENCH_SYNC_IMPL", "hostindex") == "hostindex":
        from zpix.parallel.device_entropy import (
            HostIndexJpegDecoder,
            prep_batch_host_index,
        )

        dec = HostIndexJpegDecoder(
            planar=os.environ.get("BENCH_PLANAR", "1") == "1")
        oks = []

        def run(plan):
            out, ok = dec._fused(plan)(*dec._put(plan))
            oks.append(ok)
            return out

        _h, _d, ovl = _host_device_split(prep_batch_host_index, run, datas,
                                         steps, trials, "restart-free")
        _check_ok(all(bool(k) for k in oks), "restart-free")
        return mpix / ovl
    from zpix.parallel.device_entropy_sync import SyncJpegDecoder

    dec = SyncJpegDecoder(
        chunk_bytes=int(os.environ.get("BENCH_SYNC_CHUNK", "256")))
    return _e2e(lambda: dec.decode(datas), mpix, steps, trials, "sync")


def main_prog(batch: int, size: int, steps: int, trials: int):
    """Progressive JPEG: host prep (parse + C++ index walks) and ONE fused
    device dispatch per batch; BENCH_PROG_IMPL=delta times the sparse-delta
    DeviceProgressiveDecoder instead."""
    datas = jpeg_inputs("prog", batch, size)
    mpix = batch * size * size / 1e6
    if os.environ.get("BENCH_PROG_IMPL", "onchip") == "delta":
        from zpix.parallel.progressive import DeviceProgressiveDecoder

        ddec = DeviceProgressiveDecoder()
        return _e2e(lambda: ddec.decode(datas), mpix, steps, trials, "delta")
    from zpix.parallel.progressive_onchip import OnchipProgressiveDecoder

    dec = OnchipProgressiveDecoder()
    oks = []

    def prep(d):
        pr = dec.prep(d)
        if pr is None:
            raise RuntimeError("progressive: an index pass rejected a stream")
        return pr

    def run(pr):
        out, ok = dec.run(pr)
        oks.append(ok)
        return out

    _h, _d, ovl = _host_device_split(prep, run, datas, steps, trials,
                                     "progressive")
    _check_ok(all(bool(k) for k in oks), "progressive")
    return mpix / ovl


def main_host(batch: int, size: int, steps: int, trials: int):
    """JPEG with host entropy decode: C++ scan + sparse packed upload +
    device dequant/IDCT/color (BatchJpegDecoder)."""
    from zpix.parallel.batch import BatchJpegDecoder

    datas = jpeg_inputs("plain", batch, size)
    dec = BatchJpegDecoder(packed=True)
    return _e2e(lambda: dec.decode(datas), batch * size * size / 1e6,
                steps, trials, "host")


def main_png(batch: int, size: int, steps: int, trials: int):
    """RGB8 PNG end to end: host inflate (+ defilter) and device expand,
    per ZPIX_PNG_FRONT=host|defilter|inflate."""
    from zpix.parallel.png_batch import BatchPngDecoder

    front = os.environ.get("ZPIX_PNG_FRONT", "host")
    dec = BatchPngDecoder(device_defilter=front == "defilter",
                          device_inflate=front == "inflate")
    distinct = [corpus.png_bytes(corpus.photo(size, size, 10 + s),
                                 color_type=2, depth=8) for s in range(4)]
    datas = [distinct[i % 4] for i in range(batch)]
    return _e2e(lambda: dec.decode(datas), batch * size * size / 1e6,
                steps, trials, f"png {front}")


def main_qoi(batch: int, size: int, steps: int, trials: int):
    """QOI: host record pass + device run expansion (default), or
    BENCH_QOI_IMPL=spec, the speculative BatchQoiDecoder."""
    content = os.environ.get("BENCH_QOI_CONTENT", "noise")
    gen = corpus.screen if content == "screen" else corpus.noise
    distinct = [corpus.qoi_bytes(gen(size, size, 20 + s)) for s in range(4)]
    datas = [distinct[i % 4] for i in range(batch)]
    mpix = batch * size * size / 1e6
    if os.environ.get("BENCH_QOI_IMPL", "hostindex") == "hostindex":
        from zpix.parallel.qoi_batch import (
            build_qoi_lane_expand_fn,
            prep_qoi_lanes,
            prep_qoi_lanes4,
        )

        # small lanes cut device work on dense-op content, big lanes cut
        # upload bytes on run-heavy content
        lane_p = int(os.environ.get(
            "BENCH_QOI_LANE_P", "16" if content == "noise" else "256"))
        plan0 = prep_qoi_lanes4(datas, lane_p) or prep_qoi_lanes(datas,
                                                                 lane_p)
        fn = build_qoi_lane_expand_fn(plan0)

        def prep(d):
            if plan0.fmt == "p4":
                return prep_qoi_lanes4(d, lane_p, r_hint=plan0.R)
            return prep_qoi_lanes(d, lane_p, r_hint=plan0.R)

        def run(plan):
            if plan.fmt == "p4":
                return fn(plan.p4)
            return fn(plan.cols, plan.s, plan.e)

        _h, _d, ovl = _host_device_split(prep, run, datas, steps, trials,
                                         f"qoi {content} lane_p={lane_p}")
        return mpix / ovl
    from zpix.parallel.qoi_batch import BatchQoiDecoder

    dec = BatchQoiDecoder(
        chunk_bytes=int(os.environ.get("BENCH_QOI_CHUNK", "512")),
        k_ops=int(os.environ.get("BENCH_QOI_K", "8")))
    return _e2e(lambda: dec.decode(datas), mpix, steps, trials, "qoi spec")


MODES = {
    "onchip": (main_onchip, "batched restart-interval 4:2:0 JPEG decode "
               "(device entropy)"),
    "sync": (main_sync, "batched restart-free JPEG decode"),
    "prog": (main_prog, "batched progressive JPEG decode"),
    "host": (main_host, "batched JPEG decode (host entropy)"),
    "png": (main_png, "batched PNG RGB8 decode"),
    "qoi": (main_qoi, "batched QOI decode"),
}


def main():
    import jax

    from zpix.utils.cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench: no GPU (JAX platform {dev.platform!r})")
    mode = os.environ.get("BENCH_MODE", "onchip")
    fn, name = MODES[mode]
    batch = int(os.environ.get("BENCH_BATCH", "16"))
    size = int(os.environ.get("BENCH_SIZE", "1024"))
    steps = int(os.environ.get("BENCH_STEPS", "12"))
    trials = int(os.environ.get("BENCH_TRIALS", "4"))
    mpix_s = fn(batch, size, steps, trials)
    if mode == "png":
        name += f" ({os.environ.get('ZPIX_PNG_FRONT', 'host')} front)"
    if mode == "qoi":
        name += f" [{os.environ.get('BENCH_QOI_CONTENT', 'noise')} content]"
    print(json.dumps({
        "metric": name, "value": mpix_s, "unit": "MPix/s",
        "batch": batch, "size": size,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
