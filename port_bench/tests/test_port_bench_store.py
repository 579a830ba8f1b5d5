"""The slide store: batch reads against a per-window slicing of the same
planes, the reads' guards, and the seeded slide sizes."""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from port_bench import store  # noqa: E402


@pytest.fixture(scope="module")
def slide():
    pool = store.PlanePool(11, 5, 512, "cpu")
    rng = np.random.default_rng(3)
    return store.make_slides(pool, np.array([4]), (3, 4), rng)[0]


def sliced(slide, coords, size):
    """The same windows, one numpy slice per window and plane."""
    pool, r = slide.pool, slide.pool.size
    out = [[], [], []]
    for x, y in coords:
        p = slide.cells[y // r, x // r]
        oy, ox = y % r, x % r
        out[0].append(pool.y[p, oy:oy + size, ox:ox + size].numpy())
        for k, plane in ((1, pool.cb), (2, pool.cr)):
            out[k].append(plane[p, oy // 2:(oy + size) // 2,
                                ox // 2:(ox + size) // 2].numpy())
    return [np.stack(o) for o in out]


@pytest.mark.parametrize("size", [512, 128, 64])
def test_batch_reads_equal_slicing(slide, size):
    coords = store.tissue_coords(slide, size)
    rng = np.random.default_rng(size)
    pick = coords[rng.permutation(len(coords))[:min(len(coords), 37)]]
    got = slide.read_regions_planes(pick, 0, (size, size), layout=(2, 2))
    for g, w in zip(got, sliced(slide, pick, size)):
        assert g.dtype == np.uint8 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    again = slide.read_regions_yuv420(pick, 0, (size, size))
    for g, w in zip(again, got):
        np.testing.assert_array_equal(g, w)


def test_reads_are_logged(slide):
    before = len(slide.pool.log)
    coords = store.tissue_coords(slide, 128)[:5]
    slide.read_regions_planes(coords, 0, (128, 128))
    t0, t1, px = slide.pool.log[before]
    assert t1 >= t0 and px == 5 * 128 * 128


def test_reads_off_tissue_or_misaligned_raise(slide):
    r = slide.pool.size
    empty = np.argwhere(slide.cells < 0)[0]
    with pytest.raises(IOError):
        slide.read_regions_planes([[empty[1] * r, empty[0] * r]], 0,
                                  (128, 128))
    x, y = store.tissue_coords(slide, 128)[0]
    with pytest.raises(IOError):
        slide.read_regions_planes([[x + 2, y]], 0, (128, 128))
    with pytest.raises(IOError):
        slide.read_regions_planes([[x, y]], 1, (128, 128))


def test_slide_interface(slide):
    assert slide.dct_probe(0) is None
    assert slide.yuv_layout(0) == (2, 2) and slide.supports_yuv420(0)
    assert slide.level_downsamples == [(1.0, 1.0)]
    w, h = slide.level_dimensions[0]
    assert (h, w) == (3 * 512, 4 * 512)


def test_every_seed_gets_the_same_sizes():
    a = store.slide_sizes(8, 40, 99, np.random.default_rng(1))
    b = store.slide_sizes(8, 40, 99, np.random.default_rng(2))
    assert sorted(a) == sorted(b) and list(a) != list(b)
    assert a.min() == 8 and a.max() == 40


def test_pool_is_seeded_and_h_and_e_like():
    a = store.PlanePool(5, 2, 256, "cpu")
    b = store.PlanePool(5, 2, 256, "cpu")
    c = store.PlanePool(6, 2, 256, "cpu")
    assert torch.equal(a.y, b.y) and not torch.equal(a.y, c.y)
    # background, stroma and nuclei all present
    assert a.y.float().std() > 20
    assert a.cb.shape == a.cr.shape == (2, 128, 128)


def test_a_held_read_is_never_written_again(slide):
    """Reads reuse output planes that no caller holds any more, and never
    one that a caller still holds, as a tuple, a plane or a tensor."""
    coords = store.tissue_coords(slide, 128)
    first = slide.read_regions_planes(coords[:3], 0, (128, 128))
    kept = [p.copy() for p in first]
    plane = first[1]
    tensor = torch.from_numpy(first[2])
    later = [slide.read_regions_planes(coords[3:6], 0, (128, 128))
             for _ in range(3)]
    for got, want in zip(first, kept):
        np.testing.assert_array_equal(got, want)
    assert not any(np.shares_memory(a, b) for g in later for a in g
                   for b in first)
    del first, plane, tensor, later
    a = slide.read_regions_planes(coords[:3], 0, (128, 128))
    addr = [p.ctypes.data for p in a]
    del a
    b = slide.read_regions_planes(coords[3:6], 0, (128, 128))
    assert [p.ctypes.data for p in b] == addr
    for got, want in zip(b, sliced(slide, coords[3:6], 128)):
        np.testing.assert_array_equal(got, want)
