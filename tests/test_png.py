"""PNG decode vs pngsuite SNG goldens.

Mirrors the reference's golden-text oracle strategy
(/root/reference/src/png/decoder_test.zig:8-129): decode 35 pngsuite images
and compare SNG-serialized output line-by-line, normalizing the newer sng
tool's trailing color names; basn4a16 uses a single-pixel probe because its
golden uses a gray+alpha model the image package lacks.
"""

import os

import pytest

from zpix.codecs import png

FILENAMES = [
    "basn0g01",
    "basn0g01-30",
    "basn0g02",
    "basn0g02-29",
    "basn0g04",
    "basn0g04-31",
    "basn0g08",
    "basn0g16",
    "basn2c08",
    "basn2c16",
    "basn3p01",
    "basn3p02",
    "basn3p04",
    "basn3p04-31i",
    "basn3p08",
    "basn3p08-trns",
    "basn4a08",
    "basn4a16",
    "basn6a08",
    "basn6a16",
    "ftbbn0g01",
    "ftbbn0g02",
    "ftbbn0g04",
    "ftbbn2c16",
    "ftbbn3p08",
    "ftbgn2c16",
    "ftbgn3p08",
    "ftbrn2c08",
    "ftbwn0g16",
    "ftbwn3p08",
    "ftbyn3p08",
    "ftp0n0g08",
    "ftp0n2c08",
    "ftp0n3p08",
    "ftp1n3p08",
]


def _normalize(line: str) -> str:
    if "# rgb = (" in line and not line.endswith(")"):
        i = line.rfind(") ")
        if i != -1:
            return line[: i + 1]
    return line


@pytest.mark.parametrize("name", FILENAMES)
def test_pngsuite_sng_golden(png_dir, name):
    path = os.path.join(png_dir, f"{name}.png")
    img = png.load(path)

    if name == "basn4a16":
        r, g, b, a = (int(v) for v in img.pix[1, 2])
        assert (r, g, b, a) == (0x11A7, 0x11A7, 0x11A7, 0x1085)
        return

    got = png.sng(path, img).split("\n")
    with open(os.path.join(png_dir, f"{name}.sng")) as f:
        want = [_normalize(l) for l in f.read().split("\n")]
    assert len(got) == len(want), f"line count {len(got)} vs {len(want)}"
    for i, (g_line, w_line) in enumerate(zip(got, want)):
        assert g_line == w_line, f"{name} line {i}: {g_line!r} != {w_line!r}"


def test_probe(png_dir):
    with open(os.path.join(png_dir, "basn0g01.png"), "rb") as f:
        assert png.probe_buffer(f.read(8))
    assert not png.probe_buffer(b"\xff\xd8\xff\xe0fake")


def test_decode_config(png_dir):
    with open(os.path.join(png_dir, "basn2c08.png"), "rb") as f:
        cfg = png.decode_config(f.read())
    assert (cfg.width, cfg.height) == (32, 32)


def test_crc_mismatch_rejected(png_dir):
    with open(os.path.join(png_dir, "basn0g08.png"), "rb") as f:
        data = bytearray(f.read())
    data[-5] ^= 0xFF  # corrupt IEND CRC
    import zpix.errors as errors

    with pytest.raises(errors.ChecksumError):
        png.decode(bytes(data))
