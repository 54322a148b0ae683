"""zpix — batched image decode engine in JAX.

Public API mirrors the reference's unified loader
(/root/reference/src/root.zig:24-40): probe PNG -> JPEG -> QOI -> BMP by
magic bytes, dispatch to the codec.  Batched / sharded decoding lives in
zpix.parallel.
"""

from . import errors
from .codecs import bmp, jpeg, png, qoi
from .errors import UnknownFormat
from .image import (
    CMYKImage,
    Config,
    Drawer,
    GrayImage,
    Gray16Image,
    NRGBAImage,
    NRGBA64Image,
    PalettedImage,
    Point,
    Rectangle,
    RGBAImage,
    RGBA64Image,
    YCbCrImage,
    YCbCrSubsample,
)

__version__ = "0.1.0"

_CODECS = (png, jpeg, qoi, bmp)  # probe order (src/root.zig:24-40)


def from_buffer(buf: bytes):
    """Decode an image of any supported format from a byte buffer."""
    for codec in _CODECS:
        if codec.probe_buffer(buf):
            return codec.decode(buf)
    raise UnknownFormat("zpix: no codec matched the buffer")


def from_file_path(path: str):
    """Decode an image of any supported format from a file path."""
    with open(path, "rb") as f:
        return from_buffer(f.read())


# Aliases matching common Python naming.
load = from_file_path
decode = from_buffer


def decode_config(buf: bytes) -> Config:
    """Probe image metadata without a full decode."""
    for codec in _CODECS:
        if codec.probe_buffer(buf):
            if hasattr(codec, "decode_config"):
                return codec.decode_config(buf)
            img = codec.decode(buf)
            return Config(img.width, img.height, type(img).__name__)
    raise UnknownFormat("zpix: no codec matched the buffer")


__all__ = [
    "from_buffer",
    "from_file_path",
    "load",
    "decode",
    "decode_config",
    "errors",
    "png",
    "jpeg",
    "qoi",
    "bmp",
    "Config",
    "Point",
    "Rectangle",
    "Drawer",
    "GrayImage",
    "Gray16Image",
    "RGBAImage",
    "RGBA64Image",
    "NRGBAImage",
    "NRGBA64Image",
    "CMYKImage",
    "PalettedImage",
    "YCbCrImage",
    "YCbCrSubsample",
]
