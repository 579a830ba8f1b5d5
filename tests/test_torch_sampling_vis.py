"""The port's DRAS sampling plots (hipt_abmil_atec23_tpu_torch/explain/
sampling_vis.py), drawn with numpy and cv2, checked at the output level as
tests/test_sampling_vis.py checks the JAX package's matplotlib figures:
files exist, sampled coords are marked at their mapped thumbnail
positions in the right colour, weight maps respond to the weights with
jet's colours, GIFs carry the right frame count. The thumbnail is the JAX
package's, pixel for pixel, and the ``jet`` table is matplotlib's, entry
for entry."""
import os
import sys

import numpy as np
import pytest

from hipt_abmil_atec23_tpu.explain import sampling_vis as jvis
from hipt_abmil_atec23_tpu_torch.explain import colormaps
from hipt_abmil_atec23_tpu_torch.explain.sampling_vis import (
    _thumbnail, plot_sampling, plot_weight_map, sampling_gif)
from hipt_abmil_atec23_tpu_torch.slideio.reader import ImageSlide


def _read(path):
    import cv2
    return cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)


@pytest.fixture(scope="module")
def white():
    return ImageSlide(np.full((1024, 1024, 3), 255, np.uint8), n_levels=2)


def test_thumbnail_is_the_jax_packages():
    """A one-level 3000 x 2000 slide (the shallow-pyramid case the resize
    cap is for) and a pyramid: the same thumbnail and downsamples."""
    rng = np.random.default_rng(0)
    for img, levels in ((rng.integers(0, 255, (2000, 3000, 3)), 1),
                        (rng.integers(0, 255, (1536, 1024, 3)), 3)):
        slide = ImageSlide(img.astype(np.uint8), n_levels=levels)
        got, want = _thumbnail(slide, 1000), jvis._thumbnail(slide, 1000)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]
        assert max(got[0].shape[:2]) <= 1000


def test_plot_sampling_marks_coords(white, tmp_path):
    coords = np.array([[128, 128], [640, 640], [896, 256]])
    ok, bad = str(tmp_path / "ok" / "s.png"), str(tmp_path / "bad.png")
    plot_sampling(white, coords, ok, correct=True)
    plot_sampling(white, coords, bad, correct=False)
    img_ok, img_bad = _read(ok), _read(bad)
    assert img_ok.shape == (1000, 1000, 3) or img_ok.shape[:2] == (512, 512)
    g = (img_ok[..., 1].astype(int) - img_ok[..., 0] > 40) & \
        (img_ok[..., 1].astype(int) - img_ok[..., 2] > 40)
    r = (img_bad[..., 0].astype(int) - img_bad[..., 1] > 40) & \
        (img_bad[..., 0].astype(int) - img_bad[..., 2] > 40)
    assert g.sum() >= len(coords) and r.sum() >= len(coords)
    # every mark sits at its coordinate's share of the image, and nothing
    # else is marked
    ys, xs = np.nonzero(g)
    rel = np.stack([xs / img_ok.shape[1], ys / img_ok.shape[0]], 1)
    d = np.linalg.norm(rel[:, None] - coords[None] / 1024, axis=-1)
    assert d.min(0).max() < 0.01 and d.min(1).max() < 0.02
    assert (img_ok[~g] == 255).all()


def test_plot_weight_map_responds_to_weights(white, tmp_path):
    """Flat and peaked weights render differently; a peaked patch takes
    jet's top colour and a zero one its bottom colour (blended at 0.6 over
    white); samples are gray; the colour bar runs from jet(1) at the top to
    jet(0) at the bottom."""
    coords = np.stack(np.meshgrid(np.arange(0, 1024, 128),
                                  np.arange(0, 1024, 128)), -1).reshape(-1, 2)
    flat = np.full(len(coords), 0.5)
    peaked = np.zeros(len(coords))
    peaked[:4] = 1.0
    p1, p2 = str(tmp_path / "flat.png"), str(tmp_path / "peaked.png")
    plot_weight_map(coords, flat, p1, slide=white, sample_coords=coords[-8:])
    plot_weight_map(coords, peaked, p2, slide=white,
                    sample_coords=coords[-8:])
    a, b = _read(p1), _read(p2)
    assert a.shape == b.shape
    assert np.mean(np.abs(a.astype(int) - b.astype(int))) > 1.0
    mx, mn = a.max(-1).astype(int), a.min(-1).astype(int)
    assert ((mx - mn) > 60).sum() > 100
    jet = colormaps.get_cmap("jet")
    blend = lambda c: np.rint(0.4 * 255 + 0.6 * np.asarray(c[:3]) * 255)
    # a patch spans 250 thumbnail px and the grid's step is half that:
    # the squares drawn after one cover it but its top-left quarter
    centre = lambda c: (int((c[1] + 60) / 1.024), int((c[0] + 60) / 1.024))
    np.testing.assert_allclose(b[centre(coords[3])], blend(jet(1.0)),
                               atol=1)
    np.testing.assert_allclose(b[centre(coords[4])], blend(jet(0.0)),
                               atol=1)
    # a sample: gray at 0.8 over its blended (zero-weight) square
    np.testing.assert_allclose(b[centre(coords[-1])],
                               np.rint(0.2 * blend(jet(0.0)) + 0.8 * 128),
                               atol=1)
    np.testing.assert_allclose(b[0, -1], np.rint(np.asarray(jet(1.0)[:3])
                                                 * 255), atol=1)
    np.testing.assert_allclose(b[-1, -1], np.rint(np.asarray(jet(0.0)[:3])
                                                  * 255), atol=1)


def test_plot_weight_map_bare(tmp_path):
    """Without a slide: the weight scatter on white in image orientation
    (the smallest y at the top), with its colour bar."""
    coords = np.array([[0, 0], [1000, 0], [0, 500], [1000, 500]])
    w = np.array([1.0, 0.0, 0.0, 0.0])
    path = str(tmp_path / "bare.png")
    plot_weight_map(coords, w, path, thumbnail_size=200)
    img = _read(path)
    red = (img[..., 0].astype(int) - img[..., 2] > 60)
    ys, xs = np.nonzero(red[:, :150])
    assert len(ys) and ys.max() < 10 and xs.max() < 10
    assert img.shape[0] < img.shape[1] < 300


def test_sampling_gif_frames(white, tmp_path):
    import imageio.v2 as imageio
    frames = []
    rng = np.random.default_rng(1)
    for it in range(3):
        p = str(tmp_path / f"iter{it:03d}.png")
        plot_sampling(white, rng.integers(0, 1024, (10, 2)), p)
        frames.append(p)
    gif = str(tmp_path / "anim.gif")
    sampling_gif(frames, gif, fps=2)
    rd = imageio.mimread(gif)
    assert len(rd) == 3, len(rd)
    assert rd[0].shape[:2] == _read(frames[0]).shape[:2]


def test_sampling_gif_names_imageio_when_missing(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    with pytest.raises(ImportError, match="imageio"):
        sampling_gif([], str(tmp_path / "x.gif"))
    assert not os.path.exists(tmp_path / "x.gif")


def test_jet_table_is_matplotlibs():
    """Entry for entry, and the lookup on f32 and f64 input with under,
    over and NaN."""
    from matplotlib import colormaps as mpl
    ref = mpl.get_cmap("jet")
    cm = colormaps.get_cmap("jet")
    assert cm.N == ref.N == 256
    np.testing.assert_array_equal(cm(np.arange(256) / 256.0),
                                  ref(np.arange(256) / 256.0))
    x = np.r_[np.linspace(-0.1, 1.1, 4001), np.nan, 1.0, 0.0]
    for dt in (np.float32, np.float64):
        np.testing.assert_array_equal(cm(x.astype(dt)), ref(x.astype(dt)))
