"""The benchmark's in-memory slide store: seeded H&E-like YCbCr 4:2:0
regions, served through the duck-typed slide interface that the port's
``engine/encode.encode_stream`` reads (``level_dimensions``,
``level_downsamples``, ``supports_yuv420`` / ``yuv_layout``,
``read_regions_planes``, ``read_regions_yuv420``; ``dct_probe`` gives
None, so the sparse-DCT rung stays closed).

A pool of regions is made once at set-up from the seed, on the card when
there is one, and held in pageable host memory as a slide reader's output
would be. Each slide is a grid of region cells; a tissue cell names one
pool region, so slide coordinates map onto the pool. A batch read is one
``index_select`` per plane over rows of the pool into output planes that
no caller holds any more, never a loop over patches, and every read is
logged (start and end on the host clock, pixels)
for the ``read_ms_per_mpx.*`` metrics.

The texture follows ``he_like_planes`` of the port's test fixtures
(``slideio/synthetic.py``): a smoothed random tissue field at 64 px,
nuclei at 8 px, per-pixel noise, JFIF colour and a 2 x 2 box average for
the chroma planes, with each region's tissue share, nuclei density,
stains and noise drawn apart. It is rewritten here in torch so that a
pool is made in a few large calls.
"""
from __future__ import annotations

import sys
import threading
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

BACKGROUND = (236.0, 230.0, 238.0)
STROMA = (199.0, 124.0, 180.0)
NUCLEI = (92.0, 58.0, 140.0)


def _refs(arrays) -> int:
    return max(sys.getrefcount(a) for a in arrays)


# what ``_refs`` reads of arrays that nothing else refers to
_FREE_REFS = _refs((np.empty(0),))


def _unheld(arrays) -> bool:
    """Whether nothing but the ``arrays`` list refers to its arrays (a
    tuple of them, a view or a ``torch.from_numpy`` tensor of one holds
    it)."""
    return _refs(arrays) <= _FREE_REFS


def he_like_planes(gen: torch.Generator, n: int, size: int,
                   device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """n seeded H&E-like regions as uint8 planes on ``device``: Y [n, S, S],
    Cb and Cr [n, S/2, S/2]. Each region draws its own tissue share
    (15-90%), nuclei density (5-30% of 8 px cells), stain colours and noise
    amplitude, as regions of real slides differ; with one share for all
    (the fixture's median threshold) every region is alike and HIPT's
    region features lie ~2.5% apart, about twice the bf16 path's gap."""
    def per_region(lo, hi, *shape):
        u = torch.rand((n,) + shape, generator=gen, device=device)
        return lo + (hi - lo) * u

    cell = min(64, size)
    low = torch.rand((n, size // cell, size // cell), generator=gen,
                     device=device)
    for _ in range(3):  # smooth the tissue field a little
        low = (low + low.roll(1, 1) + low.roll(1, 2) + low.roll(-1, 1)
               + low.roll(-1, 2)) / 5
    cut = torch.quantile(low.flatten(1), 1.0 - per_region(0.15, 0.9), dim=1)
    tissue = (low > cut.diagonal()[:, None, None]).repeat_interleave(cell, 1) \
        .repeat_interleave(cell, 2)
    nuclei = (torch.rand((n, size // 8, size // 8), generator=gen,
                         device=device) < per_region(0.05, 0.3, 1, 1))
    nuclei = nuclei.repeat_interleave(8, 1).repeat_interleave(8, 2) & tissue
    colours = [torch.tensor(c, device=device) + per_region(-j, j, 3)
               for c, j in ((BACKGROUND, 4.0), (STROMA, 20.0),
                            (NUCLEI, 20.0))]
    rgb = torch.where(nuclei[..., None], colours[2][:, None, None],
                      torch.where(tissue[..., None], colours[1][:, None, None],
                                  colours[0][:, None, None]))
    noise = torch.randint(-20, 21, (n, size, size, 1), generator=gen,
                          device=device) * per_region(0.5, 1.5, 1, 1, 1)
    rgb = (rgb + noise).clamp_(0, 255)
    r, g, b = rgb.unbind(-1)
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128

    def sub(c):  # 2x2 box average
        return c.reshape(n, size // 2, 2, size // 2, 2).mean((2, 4))

    def u8(a):
        return a.round().clamp_(0, 255).to(torch.uint8)

    return u8(y), u8(sub(cb)), u8(sub(cr))


class PlanePool:
    """``n`` seeded regions of ``size`` px as pageable host planes, made in
    chunks on ``device``; ``log`` holds one (start_ns, end_ns, pixels)
    per read, on the host clock (``time.time_ns``, the profiler's)."""

    # output sets kept per read shape: the stream's worker holds one while
    # it pins it, and a CPU stream up to its prefetch depth plus two
    MAX_OUTPUT_SETS = 8

    def __init__(self, seed: int, n: int, size: int, device,
                 chunk: int = 4):
        device = torch.device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        self.size = size
        self.y = torch.empty((n, size, size), dtype=torch.uint8)
        self.cb = torch.empty((n, size // 2, size // 2), dtype=torch.uint8)
        self.cr = torch.empty_like(self.cb)
        for i in range(0, n, chunk):
            k = min(chunk, n - i)
            for dst, src in zip((self.y, self.cb, self.cr),
                                he_like_planes(gen, k, size, device)):
                dst[i:i + k].copy_(src)
        self.log: List[Tuple[int, int, int]] = []
        self._lock = threading.Lock()
        self._outs: Dict[Tuple[int, int], List[List[np.ndarray]]] = {}

    @property
    def n(self) -> int:
        return self.y.shape[0]

    def _outputs(self, k: int, size: int) -> Tuple[np.ndarray, ...]:
        """Output planes for a read of k windows of ``size`` px: a set that
        no caller holds any more, else a new one, kept for reuse. A fresh
        array faults in its pages as the gather writes it, which on the
        card machine took about half of a read's time and swung with the
        host's load; a reused one is written in place."""
        sets = self._outs.setdefault((k, size), [])
        for planes in sets:
            if _unheld(planes):
                return tuple(planes)  # a new tuple: the caller holds them
        planes = [np.empty((k, size, size), np.uint8),
                  np.empty((k, size // 2, size // 2), np.uint8),
                  np.empty((k, size // 2, size // 2), np.uint8)]
        if len(sets) < self.MAX_OUTPUT_SETS:
            sets.append(planes)
        return tuple(planes)

    def gather(self, pool_ids: np.ndarray, oy: np.ndarray, ox: np.ndarray,
               size: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Y [k, s, s], Cb and Cr [k, s/2, s/2] of the s x s windows at
        (oy, ox) inside pool regions ``pool_ids``: one ``index_select``
        per plane over rows of the pool, seen as [regions * rows * (R/s),
        s], into output planes that no caller holds (``_outputs``)."""
        t0 = time.time_ns()
        with self._lock:
            out = self._outputs(len(pool_ids), size)
        for dst, plane, sub in zip(out, (self.y, self.cb, self.cr),
                                   (1, 2, 2)):
            r, s = self.size // sub, size // sub
            per_row = r // s
            rows = ((torch.from_numpy(pool_ids)[:, None] * r
                     + torch.from_numpy(oy // sub)[:, None]
                     + torch.arange(s)[None, :]) * per_row
                    + torch.from_numpy(ox // sub // s)[:, None]).reshape(-1)
            torch.index_select(plane.view(-1, s), 0, rows,
                               out=torch.from_numpy(dst).view(-1, s))
        t1 = time.time_ns()
        with self._lock:
            self.log.append((t0, t1, len(pool_ids) * size * size))
        return out


class StoreSlide:
    """One slide: a [rows, cols] grid of region cells, each a pool region
    index or -1 (no tissue), one level. Reads take windows of ``size`` px
    that lie inside one tissue cell, on a multiple of ``size`` there."""

    def __init__(self, pool: PlanePool, cells: np.ndarray):
        self.pool = pool
        self.cells = np.asarray(cells, np.int64)
        r = pool.size
        self.level_dimensions = [(self.cells.shape[1] * r,
                                  self.cells.shape[0] * r)]
        self.level_downsamples = [(1.0, 1.0)]

    def supports_yuv420(self, level: int = 0) -> bool:
        return level == 0

    def yuv_layout(self, level: int = 0):
        return (2, 2) if level == 0 else None

    def dct_probe(self, level: int = 0):
        return None

    def locate(self, locations, size: int):
        """(pool ids, oy, ox) of windows at level-0 ``locations`` [k, 2]
        (x, y); IOError for a window off a tissue cell or off the grid."""
        loc = np.asarray(locations, np.int64).reshape(-1, 2)
        r = self.pool.size
        cx, cy = loc[:, 0] // r, loc[:, 1] // r
        ox, oy = loc[:, 0] % r, loc[:, 1] % r
        rows, cols = self.cells.shape
        if (size > r or r % size or (ox % size).any() or (oy % size).any()
                or (cx < 0).any() or (cy < 0).any() or (cx >= cols).any()
                or (cy >= rows).any()):
            raise IOError(f"store reads take {size} px windows aligned "
                          f"inside {r} px cells of the grid")
        ids = self.cells[cy, cx]
        if (ids < 0).any():
            raise IOError("store read off the tissue cells")
        return ids, oy, ox

    def read_regions_planes(self, locations, level: int,
                            size: Sequence[int], n_threads: int = 0,
                            layout=(2, 2)):
        if level != 0 or tuple(layout) != (2, 2) or size[0] != size[1]:
            raise IOError("the store serves square 4:2:0 reads at level 0")
        return self.pool.gather(*self.locate(locations, size[0]), size[0])

    def read_regions_yuv420(self, locations, level: int,
                            size: Sequence[int], n_threads: int = 0):
        return self.read_regions_planes(locations, level, size, n_threads)


def slide_sizes(lo: int, hi: int, count: int,
                rng: np.random.Generator) -> np.ndarray:
    """``count`` slide sizes in regions: the whole range lo..hi, each value
    once per cycle, every cycle in its own seeded order. Every seed gets the
    same sizes in another order."""
    span = np.arange(lo, hi + 1)
    cycles = -(-count // len(span))
    return np.concatenate([rng.permutation(span)
                           for _ in range(cycles)])[:count]


def make_slides(pool: PlanePool, sizes: np.ndarray, grid: Tuple[int, int],
                rng: np.random.Generator) -> List[StoreSlide]:
    """One StoreSlide per size: that many tissue cells of a ``grid`` (rows,
    cols), drawn without replacement, each showing a seeded pool region."""
    rows, cols = grid
    out = []
    for n in sizes:
        cells = np.full(rows * cols, -1, np.int64)
        cells[rng.choice(rows * cols, int(n), replace=False)] = \
            rng.integers(0, pool.n, int(n))
        out.append(StoreSlide(pool, cells.reshape(rows, cols)))
    return out


def tissue_coords(slide: StoreSlide, step: int) -> np.ndarray:
    """Level-0 (x, y) of every ``step`` px window of the slide's tissue
    cells, region by region in row-major cell order, row-major inside."""
    r = slide.pool.size
    cy, cx = np.nonzero(slide.cells >= 0)
    k = r // step
    gy, gx = np.meshgrid(np.arange(k), np.arange(k), indexing="ij")
    x = cx[:, None] * r + gx.reshape(-1)[None, :] * step
    y = cy[:, None] * r + gy.reshape(-1)[None, :] * step
    return np.stack([x.reshape(-1), y.reshape(-1)], 1)
