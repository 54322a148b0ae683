"""tools/corpus.py: every writer's output decodes through the host codecs to
the samples it was written from, and the committed JPEGs decode."""

import numpy as np
import pytest

import zpix
from tools import corpus


def _rgba(data):
    img = zpix.from_buffer(data)
    return np.asarray(img.rgba_pixels(), np.uint8).reshape(
        img.height, img.width, 4)


def test_png_rgb8_and_rgba8_round_trip():
    rgb = corpus.photo(13, 17, 1)
    got = _rgba(corpus.png_bytes(rgb, color_type=2, depth=8))
    assert np.array_equal(got[..., :3], rgb) and (got[..., 3] == 255).all()
    rgba = np.concatenate([rgb, np.full((13, 17, 1), 255, np.uint8)], -1)
    assert np.array_equal(_rgba(corpus.png_bytes(rgba, color_type=6,
                                                 depth=8)), rgba)


@pytest.mark.parametrize("depth", [1, 2, 4, 8, 16])
def test_png_gray_depths(depth):
    rng = np.random.RandomState(depth)
    g = rng.randint(0, 1 << depth, (9, 23, 1))
    got = _rgba(corpus.png_bytes(g, color_type=0, depth=depth))
    # rgba_pixels keeps the top 8 bits of the depth-scaled sample
    scaled = (g[..., 0] * 0xFFFF // ((1 << depth) - 1)) >> 8
    assert np.array_equal(got[..., 0], scaled)


@pytest.mark.parametrize("ct,depth", [(0, 16), (2, 8), (3, 4), (6, 8)])
def test_png_adam7_matches_progressive_order(ct, depth):
    """Adam7 files decode to the same pixels as their non-interlaced twin."""
    rng = np.random.RandomState(ct)
    ch = {0: 1, 2: 3, 3: 1, 6: 4}[ct]
    s = rng.randint(0, 1 << depth, (29, 37, ch))
    pal = rng.randint(0, 256, (1 << depth, 3)) if ct == 3 else None
    flat = corpus.png_bytes(s, color_type=ct, depth=depth, palette=pal)
    adam7 = corpus.png_bytes(s, color_type=ct, depth=depth, palette=pal,
                             interlace=True)
    assert np.array_equal(_rgba(flat), _rgba(adam7))


def test_png_matrix_decodes():
    m = corpus.png_matrix()
    assert len(m) == 22
    for name, data in m.items():
        assert _rgba(data).shape == (29, 37, 4), name


def test_png_trns_color_key_is_transparent():
    rgb = np.zeros((4, 5, 3), np.int64)
    rgb[1, 2] = (85, 170, 0)
    got = _rgba(corpus.png_bytes(rgb, color_type=2, depth=8,
                                 trns=(85, 170, 0)))
    assert got[1, 2, 3] == 0 and (got[0, 0] == (0, 0, 0, 255)).all()


@pytest.mark.parametrize("top_down", [False, True])
def test_bmp_24bit_round_trip(top_down):
    rgb = corpus.photo(11, 14, 3)
    got = _rgba(corpus.bmp_bytes(rgb, top_down=top_down))
    assert np.array_equal(got[..., :3], rgb)


@pytest.mark.parametrize("bpp", [1, 4, 8])
def test_bmp_paletted_round_trip(bpp):
    rng = np.random.RandomState(bpp)
    idx = rng.randint(0, 1 << bpp, (7, 13))
    pal = rng.randint(0, 256, (1 << bpp, 3))
    got = _rgba(corpus.bmp_bytes(idx, palette=pal, bpp=bpp))
    assert np.array_equal(got[..., :3], pal[idx])


@pytest.mark.parametrize("gen", [corpus.screen, corpus.noise])
def test_qoi_round_trip(gen):
    px = gen(21, 30, 4)
    assert np.array_equal(_rgba(corpus.qoi_bytes(px)), px)


def test_committed_jpegs_decode():
    for seed in corpus.LARGE_SEEDS:
        for kind in corpus.LARGE_KINDS:
            img = zpix.from_buffer(corpus.read(corpus.large_name(seed, kind)))
            assert (img.width, img.height) == (1024, 1024)
    for name, (h, w), _opts, _mode in corpus.SMALL_JPEGS:
        img = zpix.from_buffer(corpus.read(name))
        assert (img.height, img.width) == (h, w), name


def test_large_batch_cycles_distinct_images():
    b = corpus.large_batch("dri8", 6)
    assert len(set(b)) == 4 and b[4] == b[0] and b[5] == b[1]
