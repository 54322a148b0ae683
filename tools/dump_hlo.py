#!/usr/bin/env python3
"""Dump the optimized HLO of the fused on-device JPEG decode for layout and
fusion inspection (compile only; nothing executes).

    python tools/dump_hlo.py            # writes fused.hlo

Env: BENCH_BATCH (16), HLO_OUT.
"""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from tools import corpus  # noqa: E402


def main():
    import jax

    from zpix.parallel.device_entropy import DeviceJpegDecoder, prep_batch
    from zpix.utils.cache import enable_compile_cache

    enable_compile_cache()
    batch = int(os.environ.get("BENCH_BATCH", "16"))
    plan = prep_batch(corpus.large_batch("dri8", batch))
    fn = DeviceJpegDecoder()._fused(plan)
    spec = jax.ShapeDtypeStruct(plan.packed.shape, plan.packed.dtype)
    txt = fn.lower(spec).compile().as_text()
    out = os.environ.get("HLO_OUT", "fused.hlo")
    with open(out, "w") as f:
        f.write(txt)
    print(f"wrote {len(txt) / 1e6:.1f} MB to {out}")


if __name__ == "__main__":
    main()
