"""Error taxonomy for zpix.

The reference (braheezy/zpix) surfaces failures as Zig error unions; we mirror
its error *set* as an exception hierarchy so callers can distinguish
format violations from truncation from unsupported features.

Reference error sites: /root/reference/src/jpeg/decoder.zig (FormatError /
UnexpectedEof / BadRSTMarker...), /root/reference/src/png/decoder.zig,
/root/reference/src/bmp/decoder.zig, /root/reference/src/qoi/decoder.zig.
"""


class ZpixError(Exception):
    """Base class for all zpix errors."""


class FormatError(ZpixError):
    """The input is not a syntactically valid stream of the claimed format."""


class UnsupportedError(ZpixError):
    """Valid but unsupported feature (e.g. 12-bit JPEG precision)."""


class UnexpectedEof(FormatError):
    """Input truncated mid-structure.

    Mirrors `error.UnexpectedEof` raised throughout the reference decoders
    (e.g. /root/reference/src/jpeg/decoder.zig:402-443 readByte/readFull).
    """


class BadRSTMarker(FormatError):
    """Restart-marker resync failed (jpeg).

    Mirrors `error.BadRSTMarker` (/root/reference/src/jpeg/decoder.zig:1671-1705
    findRst: a non-RST marker encountered while scanning for the expected RSTn).
    """


class ChecksumError(FormatError):
    """CRC32 / ADLER32 verification failed (png containers)."""


class UnknownFormat(ZpixError):
    """No codec's magic-byte probe matched the buffer.

    Mirrors `error.UnknownFormat` (/root/reference/src/root.zig:24-40).
    """
