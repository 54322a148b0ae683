#!/usr/bin/env python3
"""Terminal image viewer.

The reference ships an SDL2 viewer (/root/reference/example/zpixview.zig);
this environment has no display, so this renders any supported image as
ANSI half-block truecolor in the terminal (or saves a PNG with -o).

usage: python3 examples/view.py image.{png,jpg,bmp,qoi} [-o out.png] [-w COLS]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import zpix


def render_ansi(rgba: np.ndarray, cols: int) -> str:
    h, w = rgba.shape[:2]
    scale = max(1, (w + cols - 1) // cols)
    small = rgba[:: scale * 2, ::scale, :3]  # 2 rows per character cell
    lower = rgba[scale :: scale * 2, ::scale, :3]
    lines = []
    for y in range(small.shape[0]):
        row = []
        for x in range(small.shape[1]):
            tr, tg, tb = (int(v) for v in small[y, x])
            if y < lower.shape[0] and x < lower.shape[1]:
                br, bg, bb = (int(v) for v in lower[y, x])
            else:
                br, bg, bb = 0, 0, 0
            row.append(f"\x1b[38;2;{tr};{tg};{tb}m\x1b[48;2;{br};{bg};{bb}m▀")
        lines.append("".join(row) + "\x1b[0m")
    return "\n".join(lines)


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("path")
    ap.add_argument("-o", "--out", help="save as PNG instead of printing")
    ap.add_argument("-w", "--width", type=int, default=80, help="terminal columns")
    args = ap.parse_args()

    img = zpix.load(args.path)
    rgba = img.rgba_pixels().reshape(img.height, img.width, 4)
    print(f"{args.path}: {img.width}x{img.height} {type(img).__name__}", file=sys.stderr)

    if args.out:
        from PIL import Image

        Image.fromarray(rgba).save(args.out)
        print(f"wrote {args.out}", file=sys.stderr)
    else:
        print(render_ansi(rgba, args.width))
    return 0


if __name__ == "__main__":
    sys.exit(main())
