#!/usr/bin/env python3
"""PNG -> SNG text dump (the PNG test oracle, as a tool).

Port of the reference's sng CLI (/root/reference/example/sng.zig:5-42).

usage: python3 examples/sngdump.py image.png [out.sng]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from zpix.codecs import png


def main(argv):
    if len(argv) < 2 or argv[1] in ("-h", "--help"):
        print(__doc__)
        return 0 if len(argv) == 2 else 1
    img = png.load(argv[1])
    text = png.sng(argv[1], img)
    if len(argv) > 2:
        with open(argv[2], "w") as f:
            f.write(text)
        print(f"wrote {argv[2]}")
    else:
        sys.stdout.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
