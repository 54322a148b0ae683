"""Reusable overlapped decode pipeline — the pipeline-parallel analog.

The reference's decode is one serial call; the device pipeline splits it
into host front-end (marker walk / destuff / plan build), upload, and
device compute, and overlaps them ACROSS batches (SURVEY.md sec.2.7):

    parse(i+1)  [background thread]
    upload(i) + dispatch(i)  [caller thread]
    device executes (i-1)    [device, async]

Uploads and dispatches stay on the caller thread, and dispatches are
async — the caller only blocks when it materializes an output.

Works with any decoder exposing ``prep + _put + _fused`` (the on-chip
JPEG decoder) or a plan-based ``decode`` (sync JPEG / QOI / PNG via the
generic adapter).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator


class DecodePipeline:
    """Overlap host prep with device upload+dispatch across batches.

    decoder: an object with ``prep(datas) -> plan``, ``_put(plan) ->
    device buffers`` and ``_fused(plan) -> jitted fn`` — or pass
    ``prep``/``run`` callables explicitly.
    """

    def __init__(self, decoder=None, *, prep: Callable | None = None,
                 run: Callable | None = None, prefetch: int = 2,
                 workers: int | None = None):
        if decoder is not None and prep is None:
            from .device_entropy import prep_batch

            prep = getattr(decoder, "prep", None) or (
                lambda datas: prep_batch(datas)
            )
            run = lambda plan: decoder._fused(plan)(*decoder._put(plan))  # noqa: E731
        if prep is None or run is None:
            raise ValueError("need a decoder or explicit prep/run callables")
        self._prep = prep
        self._run = run
        self._prefetch = max(1, prefetch)
        # prep concurrency matches the prefetch depth by default (one
        # thread per in-flight prep); cap it explicitly on small hosts so
        # prep never starves the dispatch thread
        self._workers = max(1, workers if workers is not None else prefetch)

    def map(self, batches: Iterable[list]) -> Iterator:
        """Yield device results for each batch, prep overlapped.

        Results are UNMATERIALIZED device values (arrays / (rgb, ok)
        tuples); consume or block_until_ready as needed.  Prep runs
        ``prefetch`` batches ahead on a background thread; upload and
        dispatch stay on the caller thread.
        """
        it = iter(batches)
        with ThreadPoolExecutor(max_workers=self._workers) as pool:
            pending = []
            for b in it:
                pending.append(pool.submit(self._prep, b))
                if len(pending) >= self._prefetch:
                    break
            while pending:
                plan = pending.pop(0).result()
                try:
                    nxt = next(it)
                except StopIteration:
                    nxt = None
                if nxt is not None:
                    pending.append(pool.submit(self._prep, nxt))
                yield self._run(plan)


def jpeg_onchip_pipeline(decoder=None, prefetch: int = 2) -> DecodePipeline:
    """Pipeline over the fully on-chip JPEG decoder (restart streams)."""
    from .device_entropy import DeviceJpegDecoder, prep_batch

    dec = decoder or DeviceJpegDecoder()
    return DecodePipeline(
        prep=prep_batch,
        run=lambda plan: dec._fused(plan)(*dec._put(plan)),
        prefetch=prefetch,
    )


def qoi_onchip_pipeline(decoder=None, prefetch: int = 2) -> DecodePipeline:
    """Pipeline over the on-chip QOI decoder."""
    from .qoi_batch import BatchQoiDecoder, build_qoi_decode_fn, prep_qoi_batch

    dec = decoder or BatchQoiDecoder()

    def run(plan):
        import jax

        key = (plan.cache_key, int(plan.stream.shape[0]))
        fn = dec._fns.get(key)
        if fn is None:
            fn = build_qoi_decode_fn(plan, k_ops=dec.k_ops,
                                     ops_cap=dec.ops_cap,
                                     win_words=dec.win_words,
                                     carry_mb=dec.carry_mb)
            dec._fns[key] = fn
        return fn(
            jax.device_put(plan.stream),
            jax.device_put(plan.img_byte_start),
            jax.device_put(plan.img_byte_end),
            jax.device_put(plan.img_raw_end),
        )

    return DecodePipeline(
        prep=lambda datas: prep_qoi_batch(datas, dec.chunk_bytes),
        run=run, prefetch=prefetch,
    )
