#!/usr/bin/env python3
"""Host DEFLATE front-end throughput at bench batch sizes.

The two-pass device inflate (runtime/inflate.cpp symbol-resolve on the
host, LZ77 copy-resolve on the device) keeps the bit-serial half on
the host; this measures whether that half caps PNG throughput.
Reports, per front-end:

  - tokens/s and MB-inflated/s for the native tokenizer
  - MB-inflated/s for libdeflate (zlib_decompress_sized) and zlib
  - the MPix/s-equivalent each sustains for RGB8 rows (3.003 B/px
    inflated: 3 B/px + 1 filter byte per 1024-px row)

Pure host measurement (no jax device use).

Env: IB_BATCH (16), IB_SIZE (1024), IB_STEPS (4), IB_THREADS (cpu count).
"""

import os
import sys
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_png(size: int, seed: int) -> bytes:
    from tools import corpus

    return corpus.png_bytes(corpus.photo(size, size, seed), color_type=2,
                            depth=8)


def main():
    from zpix import runtime
    from zpix.parallel.png_batch import _walk_idat

    batch = int(os.environ.get("IB_BATCH", "16"))
    size = int(os.environ.get("IB_SIZE", "1024"))
    steps = int(os.environ.get("IB_STEPS", "4"))
    threads = int(os.environ.get("IB_THREADS", str(os.cpu_count() or 2)))

    t0 = time.perf_counter()
    pngs = [make_png(size, s) for s in range(batch)]
    print(f"gen {batch} pngs ({size}x{size} RGB8): {time.perf_counter()-t0:.1f}s")
    walked = [_walk_idat(d) for d in pngs]
    idats = [(w[1], w[2]) for w in walked]
    comp_mb = sum(len(i) for i, _ in idats) / 1e6
    out_mb = sum(e for _, e in idats) / 1e6
    mpix = batch * size * size / 1e6
    print(f"compressed {comp_mb:.1f} MB -> inflated {out_mb:.1f} MB "
          f"({mpix:.1f} MPix, {out_mb*1e6/(mpix*1e6):.3f} B/px)")

    def bench(name, fn, tokens_of=None):
        # warm
        outs = [fn(i, e) for i, e in idats]
        best = float("inf")
        for _ in range(steps):
            t0 = time.perf_counter()
            with ThreadPoolExecutor(max_workers=threads) as ex:
                outs = list(ex.map(lambda a: fn(*a), idats))
            best = min(best, time.perf_counter() - t0)
        tok = sum(tokens_of(o) for o in outs) if tokens_of else 0
        extra = f", {tok/best/1e6:.1f} Mtok/s" if tokens_of else ""
        print(
            f"{name:<28} {out_mb/best:8.0f} MB-inflated/s "
            f"({mpix/best:6.0f} MPix/s-equiv, {best*1e3:.0f} ms/batch"
            f"{extra}) [{threads} threads]"
        )
        return best

    if runtime.get_lib() is None:
        print("native runtime unavailable; tokenizer not measured")
    else:
        bench(
            "native inflate_tokens",
            lambda i, e: runtime.inflate_tokens(i, e),
            tokens_of=lambda o: len(o[0]),
        )
        bench(
            "libdeflate sized",
            lambda i, e: runtime.zlib_decompress_sized(i, e),
        )
    bench("zlib.decompress", lambda i, e: zlib.decompress(i))


if __name__ == "__main__":
    main()
