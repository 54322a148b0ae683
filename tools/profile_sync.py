#!/usr/bin/env python3
"""Stage profile of the restart-free speculative-sync JPEG decoder.

Times the _stage truncations of build_sync_decode_fn (1 = sync rounds,
2 = + record scan, 3 = + assembly, 4 = full incl. value pass + DC
restore) on one batch of the committed restart-free 1024² JPEGs, and
prints the converged round count.  Every timing ends in
block_until_ready.

    python tools/profile_sync.py

Env: PROF_STEPS (4), BENCH_BATCH (16), BENCH_SYNC_CHUNK (256).
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tools import corpus  # noqa: E402


def main():
    import jax

    from zpix.parallel.device_entropy_sync import (
        build_sync_decode_fn,
        prep_batch_sync,
    )
    from zpix.utils.cache import enable_compile_cache

    enable_compile_cache()
    batch = int(os.environ.get("BENCH_BATCH", "16"))
    steps = int(os.environ.get("PROF_STEPS", "4"))
    cb = int(os.environ.get("BENCH_SYNC_CHUNK", "256"))
    mpix = batch * corpus.LARGE_SIZE ** 2 / 1e6

    plan0 = prep_batch_sync(corpus.large_batch("plain", batch), cb)
    print(f"F={plan0.n_chunks} chunks/img cb={cb} "
          f"L={plan0.batch * plan0.n_chunks} lanes "
          f"nblk={plan0.n_mcu * plan0.bpm}/img")
    bufs = jax.block_until_ready((
        jax.device_put(plan0.stream),
        jax.device_put(plan0.img_bit_start),
        jax.device_put(plan0.img_bit_end),
    ))

    def timed(label, fn):
        t0 = time.perf_counter()
        r = jax.block_until_ready(fn(*bufs))
        compile_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        for _ in range(steps):
            r = fn(*bufs)
        jax.block_until_ready(r)
        dt = (time.perf_counter() - t1) / steps
        print(f"{label}: {dt * 1e3:7.2f} ms/batch ({mpix / dt:6.0f} MPix/s) "
              f"[compile+first {compile_s:.0f}s]", flush=True)
        return r

    r1 = timed("stage1 sync-rounds ", build_sync_decode_fn(plan0, _stage=1))
    print(f"  converged rounds: {int(r1[1])}")
    timed("stage2 +record     ", build_sync_decode_fn(plan0, _stage=2))
    timed("stage3 +assembly   ", build_sync_decode_fn(plan0, _stage=3))
    timed("stage4 full        ", build_sync_decode_fn(plan0))


if __name__ == "__main__":
    main()
