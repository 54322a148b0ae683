#!/usr/bin/env python3
"""Run every device decode path once on the GPU, checked against the host codecs.

    python chip_smoke.py                # one card: every phase
    python chip_smoke.py --four-cards   # four cards: the mesh paths only

Each phase prints its path, shapes, compile seconds (first call less one
steady call), steady-state ms per batch over at least 3 batches, and its
result against the host reference (``zpix.from_buffer(...).rgba_pixels()``).
Every device path is integer math, so every comparison is bit-exact.

Batches of 16 hold 4 distinct images, each 4 times: each distinct image is
compared with its host decode and the copies with each other.  Inputs are
the committed JPEGs under ``testdata/`` and the seeded writers of
``tools/corpus.py``.

The run refuses to start without a GPU and without the native runtime.
The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``,
printed only when every phase passed; otherwise the exit code is 1.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

PLATFORM = "gpu"  # the JAX platform every phase must run on
BATCH = 16
DISTINCT = 4
SIZE = 1024
STEADY = 3


# ---------------------------------------------------------------- helpers


def host_rgba(data: bytes) -> np.ndarray:
    """The reference: the host codecs' premultiplied RGBA8 [H, W, 4]."""
    import zpix

    img = zpix.from_buffer(data)
    return np.asarray(img.rgba_pixels(), np.uint8).reshape(
        img.height, img.width, 4
    )


def to_rgba(out, planar: bool = False) -> np.ndarray:
    """A batched decoder's output as host RGBA8 [B, H, W, 4]."""
    from zpix.parallel.bucketing import _to_rgba

    arr = np.asarray(out)
    if planar and arr.ndim == 4:
        arr = np.moveaxis(arr, 1, -1)
    return _to_rgba(arr)


def check_batch(out: np.ndarray, datas: list, distinct: int) -> str:
    """Distinct images bit-exact vs the host; repeated copies identical."""
    if out.shape[0] != len(datas):
        raise AssertionError(f"batch {out.shape[0]} != {len(datas)} inputs")
    for j in range(distinct):
        want = host_rgba(datas[j])
        if out[j].shape != want.shape:
            raise AssertionError(f"image {j}: {out[j].shape} != {want.shape}")
        bad = int(np.count_nonzero(out[j] != want))
        if bad:
            raise AssertionError(f"image {j}: {bad} samples differ from host")
    for i in range(distinct, len(datas)):
        if not np.array_equal(out[i], out[i % distinct]):
            raise AssertionError(f"copy {i} differs from image {i % distinct}")
    return (f"bit-exact vs host ({distinct} distinct, "
            f"{len(datas) - distinct} copies identical)")


def run_phase(name: str, shapes: str, call, check, steady: int = STEADY,
              batches: int = 1):
    """Time call() (which decodes `batches` batches) once cold and
    `steady` times warm, then check() the last result.  Returns (ok,
    line)."""
    import jax

    try:
        t0 = time.perf_counter()
        res = jax.block_until_ready(call())
        first = time.perf_counter() - t0
        times = []
        for _ in range(steady):
            t0 = time.perf_counter()
            res = jax.block_until_ready(call())
            times.append(time.perf_counter() - t0)
        warm = sorted(times)[len(times) // 2]
        verdict = check(res)
        line = (f"{name} | {shapes} | compile {first - warm:.1f} s | "
                f"steady {warm / batches * 1e3:.1f} ms/batch (median of "
                f"{steady} x {batches} batches) | {verdict}")
        ok = True
    except Exception as e:  # report every phase, fail the run at the end
        traceback.print_exc()
        line = f"{name} | {shapes} | FAILED: {type(e).__name__}: {e}"
        ok = False
    print(line, flush=True)
    return ok, line


def batch_of(distinct: list) -> list:
    return [distinct[i % len(distinct)] for i in range(BATCH)]


def ok_and(out_ok, planar: bool = False):
    """(out, ok) decoders: ok must be True, out goes to the check."""
    out, ok = out_ok
    if not bool(ok):
        raise AssertionError("decoder reported ok=False")
    return to_rgba(out, planar)


# ---------------------------------------------------------------- inputs


def jpeg_batch(kind: str) -> list:
    from tools import corpus

    return corpus.large_batch(kind, BATCH)


def png_batch(size: int = SIZE) -> list:
    from tools import corpus

    return batch_of([corpus.png_bytes(corpus.photo(size, size, 10 + s),
                                      color_type=2, depth=8)
                     for s in range(DISTINCT)])


def qoi_batch(content: str, size: int = SIZE) -> tuple:
    from tools import corpus

    gen = corpus.noise if content == "noise" else corpus.screen
    pix = [gen(size, size, 20 + s) for s in range(DISTINCT)]
    return batch_of([corpus.qoi_bytes(p) for p in pix]), pix


def bmp_batch(size: int = SIZE) -> list:
    from tools import corpus

    return batch_of([corpus.bmp_bytes(corpus.photo(size, size, 30 + s))
                     for s in range(DISTINCT)])


def mixed_inputs(large: bool = True) -> list:
    """Every committed small JPEG, small PNG (16-bit alpha, paletted tRNS,
    Adam7), BMP and QOI files from the writers, plus (large=True) one
    large file of each format."""
    from tools import corpus

    names = sorted(n for n in os.listdir(corpus.TESTDATA)
                   if not n.startswith("photo"))
    bufs = [corpus.read(n) for n in names]
    pngs = corpus.png_matrix()
    bufs += [pngs[n] for n in ("ct6_d16.png", "ct3_d4_trns.png",
                               "ct2_d8_adam7.png")]
    bufs += [corpus.bmp_set()["pal8.bmp"],
             corpus.qoi_bytes(corpus.screen(33, 47, 1))]
    if large:
        bufs += [corpus.read(corpus.large_name(0, k))
                 for k in corpus.LARGE_KINDS]
        bufs += [png_batch()[0], qoi_batch("screen")[0][0], bmp_batch()[0]]
    return bufs


# ---------------------------------------------------------------- phases


def phase_jpeg_restart(datas, distinct=DISTINCT, steady=STEADY):
    """The main path: restart-interval JPEG, entropy decode on the device,
    through the overlapped pipeline."""
    from zpix.parallel import device_entropy as de
    from zpix.parallel.device_entropy import DeviceJpegDecoder
    from zpix.parallel.pipeline import jpeg_onchip_pipeline

    pipe = jpeg_onchip_pipeline(DeviceJpegDecoder(planar=True))

    def check(results):
        for r in results[:-1]:
            ok_and(r)
        return check_batch(ok_and(results[-1], planar=True), datas, distinct)

    unroll = f"K={de._DEF_K} K1={de._DEF_K1} W={de._DEF_W} W1={de._DEF_W1}"
    return run_phase(
        "jpeg restart-interval, DeviceJpegDecoder(planar) pipeline",
        _shape(datas) + f", {unroll}",
        lambda: list(pipe.map([datas] * steady)), check,
        steady=2, batches=steady,
    )


def _decoders() -> dict:
    """Phase id -> (label, decoder constructor) for the batched decoders."""
    from functools import partial

    from zpix.parallel.batch import BatchJpegDecoder
    from zpix.parallel.bmp_batch import BatchBmpDecoder
    from zpix.parallel.device_entropy import HostIndexJpegDecoder
    from zpix.parallel.png_batch import BatchPngDecoder
    from zpix.parallel.progressive_onchip import OnchipProgressiveDecoder
    from zpix.parallel.qoi_batch import BatchQoiDecoder, HostIndexQoiDecoder

    return {
        "restart-free": ("jpeg restart-free, HostIndexJpegDecoder",
                         HostIndexJpegDecoder),
        "progressive": ("jpeg progressive, OnchipProgressiveDecoder"
                        "(hostindex)", OnchipProgressiveDecoder),
        "host-entropy": ("jpeg host-entropy, BatchJpegDecoder(packed)",
                         partial(BatchJpegDecoder, packed=True)),
        "png-host": ("png host front, BatchPngDecoder()", BatchPngDecoder),
        "png-defilter": ("png defilter front, BatchPngDecoder"
                         "(device_defilter)",
                         partial(BatchPngDecoder, device_defilter=True)),
        "png-inflate": ("png inflate front, BatchPngDecoder(device_inflate)",
                        partial(BatchPngDecoder, device_inflate=True)),
        "qoi": ("qoi, HostIndexQoiDecoder", HostIndexQoiDecoder),
        "qoi-speculative": ("qoi speculative scan, BatchQoiDecoder",
                            BatchQoiDecoder),
        "bmp": ("bmp, BatchBmpDecoder", BatchBmpDecoder),
    }


def phase_decode(kind: str, datas, distinct=DISTINCT, steady=STEADY,
                 note: str = ""):
    """One batched decoder's decode(datas): its output (or (out, ok) with
    ok True) checked bit-exact against the host codecs."""
    label, make = _decoders()[kind]
    dec = make()

    def check(r):
        out = ok_and(r) if isinstance(r, tuple) else to_rgba(r)
        return check_batch(out, datas, distinct)

    return run_phase(f"{label}{note}", _shape(datas),
                     lambda: dec.decode(datas), check, steady)


def phase_qoi_encode(pixels: list, steady=STEADY):
    """encode_device must be byte-identical to the serial encoder."""
    from tools import corpus
    from zpix.codecs.qoi.encode import Desc
    from zpix.parallel.qoi_batch import encode_device

    px = pixels[0]
    h, w = px.shape[:2]

    def check(got):
        want = corpus.qoi_bytes(px)
        if got != want:
            raise AssertionError(
                f"encode_device {len(got)} bytes != encode {len(want)} bytes")
        return f"byte-identical to encode ({len(got)} bytes)"

    return run_phase(
        "qoi encode_device", f"1 x {h}x{w} RGBA8",
        lambda: encode_device(px, Desc(w, h, 4, 0)), check, steady,
    )


def phase_decode_mixed(bufs, steady=STEADY):
    """Public API over every format; every route must be the device,
    except progressive CMYK, which the router sends to the host."""
    from zpix.parallel.bucketing import decode_mixed, probe_key

    keys = [probe_key(b) for b in bufs]
    # progressive CMYK/YCCK has no batched path (bucketing.py)
    by_design = sum(1 for k in keys
                    if k[0] == "jpeg" and len(k) == 6 and k[3] == 4 and k[5])

    def check(res):
        outs, stats = res
        routes = {k: v for k, v in stats.items() if k != "device"}
        if routes != ({"host-routed": by_design} if by_design else {}):
            raise AssertionError(f"routes {stats}")
        for i, (o, b) in enumerate(zip(outs, bufs)):
            if not np.array_equal(o, host_rgba(b)):
                raise AssertionError(f"input {i} ({probe_key(b)}) differs")
        return f"bit-exact vs host ({len(bufs)} inputs), routes {stats}"

    return run_phase(
        "decode_mixed (public API)",
        f"{len(bufs)} inputs ({', '.join(sorted({k[0] for k in keys}))}), "
        f"{len(set(keys))} buckets",
        lambda: decode_mixed(bufs, return_stats=True), check, steady,
    )


def _shape(datas) -> str:
    from zpix.parallel.bucketing import probe_key

    k = probe_key(datas[0])
    return f"{len(datas)} x {k[2]}x{k[1]} {k[0]}"


# ---------------------------------------------------------------- four cards


def four_card_phases():
    """make_mesh() over 4 GPUs: each sharded decode vs the same batch on
    one card, with the output shards on 4 distinct GPUs."""
    from tools import corpus
    from zpix.parallel import make_mesh
    from zpix.parallel.batch import BatchJpegDecoder
    from zpix.parallel.bucketing import decode_mixed
    from zpix.parallel.device_entropy import DeviceJpegDecoder

    mesh = make_mesh()
    dri8 = jpeg_batch("dri8")
    plain = jpeg_batch("plain")

    def on_four(out):
        devs = {s.device for s in out.addressable_shards}
        if len(devs) != 4 or any(d.platform != PLATFORM for d in devs):
            raise AssertionError(f"output shards on {sorted(map(str, devs))}")
        return f"shards on {len(devs)} distinct devices"

    def vs_one(sharded, one, planar=False):
        a, b = to_rgba(sharded, planar), to_rgba(one, planar)
        if not np.array_equal(a, b):
            raise AssertionError(
                f"{int(np.count_nonzero(a != b))} samples differ from 1 card")
        return "bit-exact vs 1 card"

    one = DeviceJpegDecoder(planar=True)
    ref = ok_and(one.decode(dri8), planar=True)
    check_batch(ref, dri8, DISTINCT)
    sharded = DeviceJpegDecoder(mesh=mesh, packed=True, planar=True)
    results = [run_phase(
        "4 cards: DeviceJpegDecoder(mesh, packed) shard_map",
        _shape(dri8) + f", mesh {dict(mesh.shape)}",
        lambda: sharded.decode(dri8),
        lambda r: (f"{on_four(r[0])}, "
                   f"{vs_one(ok_and(r, planar=True), ref)}"),
    )]

    ref_b = BatchJpegDecoder(packed=True).decode(plain)
    mdec = BatchJpegDecoder(mesh=make_mesh())
    results.append(run_phase(
        "4 cards: BatchJpegDecoder(mesh)",
        _shape(plain) + f", mesh {dict(mesh.shape)}",
        lambda: mdec.decode(plain),
        lambda r: f"{on_four(r)}, {vs_one(r, ref_b)}",
    ))

    # one bucket per format that takes the mesh, each a multiple of 4
    # images so it shards evenly
    bufs = [corpus.read("gray.jpg"), corpus.read("444.jpg"),
            corpus.png_matrix()["ct2_d8.png"], corpus.bmp_set()["rgb24.bmp"],
            corpus.qoi_bytes(corpus.screen(33, 47, 1))]
    bufs = [b for b in bufs for _ in range(4)]
    ref_m, _ = decode_mixed(bufs, return_stats=True)

    def check_mixed(res):
        outs, stats = res
        if set(stats) != {"device"}:
            raise AssertionError(f"routes {stats}")
        for i, (a, b) in enumerate(zip(outs, ref_m)):
            if not np.array_equal(a, b):
                raise AssertionError(f"input {i} differs from 1 card")
        return f"bit-exact vs 1 card ({len(bufs)} inputs), routes {stats}"

    results.append(run_phase(
        "4 cards: decode_mixed(mesh)", f"{len(bufs)} inputs",
        lambda: decode_mixed(bufs, mesh=mesh, return_stats=True),
        check_mixed,
    ))
    return results


# ---------------------------------------------------------------- main


def one_card_phases():
    from tools import corpus

    # progressive JPEGs carry per-image optimized Huffman tables and the
    # progressive decoder bakes one scan script per batch: one image x 16
    prog = [corpus.read(corpus.large_name(0, "prog"))] * BATCH
    results = [
        phase_jpeg_restart(jpeg_batch("dri8")),
        phase_decode("restart-free", jpeg_batch("plain")),
        phase_decode("progressive", prog, distinct=1),
        phase_decode("host-entropy", jpeg_batch("plain")),
    ]
    pngs = png_batch()
    for front in ("host", "defilter", "inflate"):
        results.append(phase_decode(f"png-{front}", pngs))
    for content in ("noise", "screen"):
        datas, pix = qoi_batch(content)
        results.append(phase_decode("qoi", datas, note=f" ({content})"))
        results.append(phase_qoi_encode(pix))
    results.append(phase_decode("qoi-speculative",
                                qoi_batch("screen", 64)[0]))
    results.append(phase_decode("bmp", bmp_batch(), note=" (24-bit)"))
    results.append(phase_decode_mixed(mixed_inputs()))
    return results


def main(argv: list) -> int:
    four = "--four-cards" in argv
    import jax

    devs = jax.devices()
    if devs[0].platform != PLATFORM:
        print(f"chip_smoke: no GPU (JAX platform {devs[0].platform!r})",
              file=sys.stderr)
        return 1
    want = 4 if four else 1
    if len(devs) < want:
        print(f"chip_smoke: needs {want} GPUs, JAX sees {len(devs)}",
              file=sys.stderr)
        return 1

    from zpix import runtime
    from zpix.utils.cache import enable_compile_cache

    cache = enable_compile_cache()
    if runtime.get_lib() is None:
        print("chip_smoke: the native runtime did not build", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"device_kind: {devs[0].device_kind} x {len(devs)}")
    print(f"nvidia-smi: {smi}")
    print(f"jax {jax.__version__}, compile cache {cache}")
    print("png inflate: "
          + ("libdeflate" if runtime._get_libdeflate() else "zlib"), flush=True)

    t0 = time.perf_counter()
    results = four_card_phases() if four else one_card_phases()
    n_bad = sum(1 for ok, _ in results if not ok)
    print(f"{len(results) - n_bad}/{len(results)} phases passed in "
          f"{time.perf_counter() - t0:.0f} s", flush=True)
    if n_bad:
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
