#!/usr/bin/env python3
"""Stage profile of the on-device restart-interval JPEG decode.

Times pass 1 (index pass), pass 1+2 (+integrity), the fused
entropy+IDCT+color program and optional back-end truncations on one
staged batch of the committed 1024² JPEGs; every timing ends in
block_until_ready.

    python tools/profile_onchip.py

Env: PROF_STEPS (8), PROF_STAGES (1,17,fused; also soa, bk, pix, planes,
ups, rgbr), BENCH_BATCH (16), ZPIX_ONCHIP_*.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tools import corpus  # noqa: E402


def main():
    import jax

    from zpix.parallel.device_entropy import (
        DeviceJpegDecoder,
        _soa_backend,
        build_decode_fn,
        prep_batch,
    )
    from zpix.utils.cache import enable_compile_cache

    enable_compile_cache()
    batch = int(os.environ.get("BENCH_BATCH", "16"))
    steps = int(os.environ.get("PROF_STEPS", "8"))
    datas = corpus.large_batch("dri8", batch)
    mpix = batch * corpus.LARGE_SIZE ** 2 / 1e6

    t0 = time.perf_counter()
    p0 = prep_batch(datas)
    print(f"host prep: {(time.perf_counter() - t0) * 1e3:.1f} ms/batch | "
          f"stream={p0.stream.shape[0]}B n_segs={p0.n_segs} bpm={p0.bpm} "
          f"max_seg_bits={p0.max_seg_bits}")
    dec = DeviceJpegDecoder()
    t0 = time.perf_counter()
    bufs = jax.block_until_ready(dec._put(p0))
    print(f"upload: {(time.perf_counter() - t0) * 1e3:.1f} ms/batch")

    def timed(label, fn):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*bufs))
        compile_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        for _ in range(steps):
            r = fn(*bufs)
        jax.block_until_ready(r)
        dt = (time.perf_counter() - t1) / steps
        print(f"{label}: {dt * 1e3:.2f} ms/batch ({mpix / dt:.0f} MPix/s) "
              f"[compile+first {compile_s:.1f}s]", flush=True)

    for w in os.environ.get("PROF_STAGES", "1,17,fused").split(","):
        if w == "fused":
            timed("fused full", dec._fused(p0))
        elif w == "soa":  # entropy + DC restore, no back-end
            timed("soa coeffs", build_decode_fn(p0, packed=True,
                                                _soa_out=True))
        elif w in ("pix", "planes", "ups", "rgbr", "bk"):
            body = build_decode_fn(p0, packed=True, _soa_out=True, _raw=True)
            stop = None if w == "bk" else w

            def f(*args, body=body, stop=stop):
                coeffs, ok = body(*args)
                return _soa_backend(p0, coeffs, _stop=stop), ok

            timed(f"+backend[{w}]", jax.jit(f))
        else:
            timed(f"stage {w}", build_decode_fn(p0, _stage=int(w),
                                                packed=True))


if __name__ == "__main__":
    main()
