#!/usr/bin/env python3
"""Any-format -> QOI converter.

Port of the reference's convert tool (/root/reference/example/convert.zig:17-86):
decode any supported image, flatten to RGBA8, encode as QOI.

usage: python3 examples/convert.py input.{png,jpg,bmp,qoi} output.qoi
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import zpix
from zpix.codecs import qoi


def main(argv):
    if len(argv) != 3 or argv[1] in ("-h", "--help"):
        print(__doc__)
        return 0 if len(argv) == 2 else 1
    img = zpix.load(argv[1])
    rgba = img.rgba_pixels()
    data = qoi.encode(rgba, qoi.Desc(img.width, img.height, 4, 0))
    with open(argv[2], "wb") as f:
        f.write(data)
    print(f"{argv[1]} ({img.width}x{img.height}) -> {argv[2]} ({len(data)} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
