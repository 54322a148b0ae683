"""Batched + sharded decoding over a JAX device mesh.

The reference is single-threaded by construction (SURVEY.md sec.2.7); this
package supplies the device parallelism layers:

* data parallel — a batch of images sharded over the mesh 'batch' axis
* intra-image stripe parallel — MCU-row stripes over the 'stripe' axis
  (the sequence-parallel analog; restart segments are the host-side lanes)

All device work is one jitted XLA graph per (shape, ratio) bucket.
"""

from .mesh import make_mesh, batch_sharding
from .batch import BatchJpegDecoder, decode_batch_ycbcr_to_rgb
from .bucketing import decode_mixed, load_batch, plan_buckets
from .device_entropy import DeviceJpegDecoder
from .device_entropy_sync import SyncJpegDecoder
from .png_batch import BatchPngDecoder
from .qoi_batch import BatchQoiDecoder
from .bmp_batch import BatchBmpDecoder
from .progressive import DeviceProgressiveDecoder
from .progressive_onchip import OnchipProgressiveDecoder

__all__ = [
    "make_mesh",
    "batch_sharding",
    "BatchJpegDecoder",
    "BatchPngDecoder",
    "BatchBmpDecoder",
    "BatchQoiDecoder",
    "DeviceProgressiveDecoder",
    "OnchipProgressiveDecoder",
    "DeviceJpegDecoder",
    "SyncJpegDecoder",
    "decode_batch_ycbcr_to_rgb",
    "decode_mixed",
    "load_batch",
    "plan_buckets",
]
