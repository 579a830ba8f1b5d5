"""The port's tile stage (slideio/pipeline.py seg_and_patch and what it
calls: segmentation pickle and overlay, coords h5, stitch, presets) and its
host helpers (slideio/legacy.py, ops/augment.py), held against the JAX
package on the same synthetic slides and seeded inputs. All host code, so
every comparison is exact: equal arrays, equal files, equal bytes."""
import dataclasses
import os

import cv2
import h5py
import numpy as np
import pandas as pd
import pytest

from hipt_abmil_atec23_tpu.ops import augment as jaug
from hipt_abmil_atec23_tpu.slideio import legacy as jleg
from hipt_abmil_atec23_tpu.slideio import native
from hipt_abmil_atec23_tpu.slideio import patching as jpatch
from hipt_abmil_atec23_tpu.slideio import pipeline as jpipe
from hipt_abmil_atec23_tpu.slideio import seg as jseg
from hipt_abmil_atec23_tpu.slideio.reader import TiffSlide as JaxTiffSlide
from hipt_abmil_atec23_tpu.slideio.stitch import stitch_coords as jstitch
from hipt_abmil_atec23_tpu.slideio.synthetic import write_synthetic_slide
from hipt_abmil_atec23_tpu.utils import config as jcfg
from hipt_abmil_atec23_tpu_torch.ops import augment as taug
from hipt_abmil_atec23_tpu_torch.slideio import legacy as tleg
from hipt_abmil_atec23_tpu_torch.slideio import patching as tpatch
from hipt_abmil_atec23_tpu_torch.slideio import pipeline as tpipe
from hipt_abmil_atec23_tpu_torch.slideio import seg as tseg
from hipt_abmil_atec23_tpu_torch.slideio.reader import TiffSlide
from hipt_abmil_atec23_tpu_torch.slideio.stitch import stitch_coords
from hipt_abmil_atec23_tpu_torch.utils import config as tcfg

SEG = dict(use_otsu=True, close=4, a_t=1)


@pytest.fixture(scope="module")
def slide_dir(tmp_path_factory):
    """Two synthetic slides: a YCbCr 4:2:0 JPEG and a DEFLATE one."""
    d = tmp_path_factory.mktemp("tile_src")
    write_synthetic_slide(str(d / "a.tif"), 1536, 1024, n_levels=3,
                          ycbcr420=True, seed=3)
    write_synthetic_slide(str(d / "b.tif"), 1024, 1280, n_levels=3,
                          compression=native.COMPRESSION_DEFLATE, seed=4)
    return d


def _tile_cfg(cfg_mod):
    return cfg_mod.TileConfig(patch_size=256, step_size=256,
                              seg=cfg_mod.SegConfig(**SEG))


@pytest.fixture(scope="module")
def tiled(slide_dir, tmp_path_factory):
    """Both packages' seg_and_patch over the same folder, with a preset
    and a process list that overrides one slide's median blur."""
    out = tmp_path_factory.mktemp("tile_out")
    plist = str(out / "process_list.csv")
    pd.DataFrame([{"slide_id": "b.tif", "mthresh": 5, "process": 1}]).to_csv(
        plist, index=False)
    res = {}
    for name, pipe, cfg_mod in (("jax", jpipe, jcfg), ("port", tpipe, tcfg)):
        res[name] = pipe.seg_and_patch(
            str(slide_dir), str(out / name), _tile_cfg(cfg_mod),
            preset="bwh_biopsy", process_list=plist, verbose=False)
    return out, res


def test_seg_and_patch_matches_jax(tiled, slide_dir):
    """The same coords h5 (coords and attrs, save_path aside), the same
    process-list journal, and the same mask and stitch images, byte for
    byte; a second run skips both slides as already_exist."""
    out, res = tiled
    pd.testing.assert_frame_equal(res["port"].df, res["jax"].df)
    assert list(res["port"].df["status"]) == ["processed", "processed"]
    for sid in ("a", "b"):
        jc, ja = jpatch.load_coords_h5(str(out / "jax/patches" / f"{sid}.h5"))
        tc, ta = tpatch.load_coords_h5(str(out / "port/patches"
                                           / f"{sid}.h5"))
        assert len(tc) > 0
        np.testing.assert_array_equal(tc, jc)
        assert set(ta) == set(ja)
        for k in ja:
            if k != "save_path":
                np.testing.assert_array_equal(ta[k], ja[k])
        for sub in ("masks", "stitches"):
            np.testing.assert_array_equal(
                cv2.imread(str(out / "port" / sub / f"{sid}.jpg")),
                cv2.imread(str(out / "jax" / sub / f"{sid}.jpg")))
    journals = [pd.read_csv(out / n / "process_list_autogen.csv")
                for n in ("jax", "port")]
    pd.testing.assert_frame_equal(journals[1], journals[0])
    rerun = tpipe.seg_and_patch(str(slide_dir), str(out / "port"),
                                _tile_cfg(tcfg), verbose=False)
    assert list(rerun.df["status"]) == ["already_exist", "already_exist"]


def test_process_df_overrides_match_jax(slide_dir):
    """initialize_process_df merges an existing list's overrides (and
    leaves NaN cells at the defaults) as the JAX package does."""
    existing = pd.DataFrame([{"slide_id": "a.tif", "sthresh": 20,
                              "use_otsu": np.nan, "status": "done"}])
    want = jpipe.initialize_process_df(["a.tif", "b.tif"], _tile_cfg(jcfg),
                                       existing)
    got = tpipe.initialize_process_df(["a.tif", "b.tif"], _tile_cfg(tcfg),
                                      existing)
    pd.testing.assert_frame_equal(got, want)


@pytest.mark.parametrize("preset", ["default", "betterseg", "bwh_biopsy",
                                    "csv"])
def test_seg_presets_match_jax(preset, tmp_path):
    """Named presets and a reference-format preset CSV give the JAX
    package's SegConfig; an unknown name raises in both."""
    if preset == "csv":
        preset = str(tmp_path / "preset.csv")
        pd.DataFrame([{"sthresh": 15, "mthresh": 5, "close": 100,
                       "use_otsu": True, "a_t": 3, "unrelated": "x"}]).to_csv(
            preset, index=False)
    got = tcfg.apply_seg_preset(tcfg.SegConfig(), preset)
    want = jcfg.apply_seg_preset(jcfg.SegConfig(), preset)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    with pytest.raises(KeyError):
        tcfg.apply_seg_preset(tcfg.SegConfig(), "nope")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_coords_h5_and_segmentation_cross_load(writer, slide_dir, tmp_path):
    """A coords h5 and a segmentation pickle written by either package
    load in the other with equal contents."""
    w, r = (jpatch, tpatch) if writer == "jax" else (tpatch, jpatch)
    ws, rs = (jseg, tseg) if writer == "jax" else (tseg, jseg)
    slide = TiffSlide(str(slide_dir / "a.tif"))
    try:
        seg = tseg.segment_tissue(slide, tcfg.SegConfig(**SEG))
        coords = tpatch.enumerate_coords(slide, seg, _tile_cfg(tcfg))
        attrs = w.coords_attrs(slide, _tile_cfg(tcfg), "a", str(tmp_path))
    finally:
        slide.close()
    path = str(tmp_path / "a.h5")
    w.save_coords_h5(path, coords, attrs)
    got, got_attrs = r.load_coords_h5(path)
    np.testing.assert_array_equal(got, coords)
    assert got.dtype == np.int64
    assert set(got_attrs) == set(attrs)
    for k, v in attrs.items():
        np.testing.assert_array_equal(got_attrs[k], v)
    pkl = str(tmp_path / "a_seg.pkl")
    ws.SegmentationResult(seg.contours, seg.holes, seg.seg_level).save(pkl)
    back = rs.SegmentationResult.load(pkl)
    assert back.seg_level == seg.seg_level
    for c, d in zip(back.contours, seg.contours):
        np.testing.assert_array_equal(c, d)
    assert [len(h) for h in back.holes] == [len(h) for h in seg.holes]


def test_overlay_stitch_and_external_contours_match_jax(slide_dir,
                                                        tmp_path):
    """draw_segmentation, stitch_coords and load_external_contours give
    the JAX package's arrays."""
    tslide = TiffSlide(str(slide_dir / "b.tif"))
    jslide = JaxTiffSlide(str(slide_dir / "b.tif"))
    try:
        seg = tseg.segment_tissue(tslide, tcfg.SegConfig(**SEG))
        jsegr = jseg.segment_tissue(jslide, jcfg.SegConfig(**SEG))
        coords = tpatch.enumerate_coords(tslide, seg, _tile_cfg(tcfg))
        np.testing.assert_array_equal(
            tseg.draw_segmentation(tslide, seg),
            jseg.draw_segmentation(jslide, jsegr))
        np.testing.assert_array_equal(
            stitch_coords(tslide, coords, 256, downscale=8),
            jstitch(jslide, coords, 256, downscale=8))
    finally:
        tslide.close()
        jslide.close()
    npy = str(tmp_path / "contours.npy")
    arr = np.empty(2, object)
    arr[0] = [[10, 10], [200, 10], [200, 300]]
    arr[1] = [[400, 400], [500, 450], [450, 600], [380, 520]]
    np.save(npy, arr, allow_pickle=True)
    got, want = (m.load_external_contours(npy) for m in (tseg, jseg))
    assert got.seg_level == want.seg_level == 0
    for c, d in zip(got.contours, want.contours):
        np.testing.assert_array_equal(c, d)
    assert got.holes == want.holes


def _legacy_case(name, mod, tmp_path):
    """One legacy helper of ``mod`` (the JAX or the port module) on fixed
    inputs; returns what it produced, as arrays or plain values."""
    from hipt_abmil_atec23_tpu_torch.slideio.reader import ImageSlide
    from hipt_abmil_atec23_tpu_torch.slideio.synthetic import (
        make_tissue_image)
    rng = np.random.default_rng(11)
    if name == "white_black":
        patches = [np.full((64, 64, 3), v, np.uint8) for v in (250, 5, 128)]
        patches.append(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8))
        return [(mod.is_white_patch(p), mod.is_black_patch(p),
                 mod.is_white_patch(p, 40), mod.is_black_patch(p, 140))
                for p in patches]
    if name == "save_hdf5":
        path = str(tmp_path / f"{mod.__name__}.h5")
        mod.save_hdf5(path, {"x": np.ones((3, 4)), "c": np.arange(6)
                             .reshape(3, 2)}, {"x": {"meta": 1}})
        mod.save_hdf5(path, {"x": np.zeros((2, 4)), "c": np.ones((2, 2))})
        with h5py.File(path) as f:
            return [np.asarray(f["x"]), np.asarray(f["c"]),
                    f["x"].attrs["meta"]]
    if name == "patch_bag":
        img = make_tissue_image(1024, 1024, seed=1)
        img[:256, :256] = 255
        img[768:, 768:] = 0
        coords = np.array([[0, 0], [256, 256], [512, 512], [768, 768]],
                          np.int64)
        path = str(tmp_path / f"{mod.__name__}_bag.h5")
        kept = mod.create_patch_bag_hdf5(ImageSlide(img), coords, path,
                                         patch_size=256, batch=3)
        return [kept, *mod.load_patch_bag_hdf5(path)]
    if name == "mosaic":
        m = mod.MosaicCanvas(patch_size=64, n=5, downscale=2, n_per_row=2,
                             bg_color=(9, 9, 9))
        for _ in range(5):
            m.paste(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8))
        path = str(tmp_path / f"{mod.__name__}_mosaic.png")
        m.save(path)
        return [m.canvas, cv2.imread(path)]
    xml = tmp_path / "a.xml"
    xml.write_text("""<root><Annotations>
      <Annotation><Coordinates>
        <Coordinate X="0" Y="0"/><Coordinate X="10" Y="0"/>
        <Coordinate X="10" Y="10"/><Coordinate X="0" Y="10"/>
      </Coordinates></Annotation>
      <Annotation><Coordinates>
        <Coordinate X="0" Y="0"/><Coordinate X="100" Y="0"/>
        <Coordinate X="100" Y="100"/><Coordinate X="0" Y="100"/>
      </Coordinates></Annotation>
    </Annotations></root>""")
    txt = tmp_path / "a.txt"
    txt.write_text("{'tumor': [[(0,0),(5,0),(5,5)], [(0,0),(50,0),(50,50),"
                   "(0,50)]], 'other': [[(1,1),(9,1),(9,9)]]}")
    return (mod.load_annotations_xml(str(xml))
            + mod.load_annotations_txt(str(txt)))


@pytest.mark.parametrize("name", ["white_black", "save_hdf5", "patch_bag",
                                  "mosaic", "annotations"])
def test_legacy_helpers_match_jax(name, tmp_path):
    """Each slideio/legacy.py helper gives the JAX package's result:
    patch filters, the appending h5 writer, the pixel bag (a white and a
    black patch dropped), the mosaic sheet and its file, the annotation
    loaders (largest contour first)."""
    got = _legacy_case(name, tleg, tmp_path)
    want = _legacy_case(name, jleg, tmp_path)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if name == "patch_bag":
        assert 1 <= got[0] <= 2  # the white and the black patch dropped


@pytest.mark.parametrize("preset", jaug.TRANSFORM_PRESETS)
def test_transform_presets_byte_identical(preset):
    """Every preset of ops/augment.build_transform gives the JAX package's
    bytes at one seed over two successive batches (the preset's generator
    carries from one to the next); 'none' and 'HIPT' are no transform.
    Macenko's batch holds one H&E-like patch and one blank patch (its
    failure pass-through, counted)."""
    rng = np.random.default_rng(5)
    he = np.array([[0.65, 0.70, 0.29], [0.07, 0.99, 0.11]])
    stained = np.clip(240 * np.exp(-rng.uniform(0.05, 1.0, (48 * 48, 2)) @ he),
                      0, 255).astype(np.uint8).reshape(48, 48, 3)
    batches = [rng.integers(0, 256, (3, 48, 48, 3), dtype=np.uint8)
               for _ in range(2)]
    if preset == "macenko":
        batches = [np.stack([stained, np.full_like(stained, 255)])] * 2
    got_t, want_t = (m.build_transform(preset, seed=7) for m in (taug, jaug))
    if preset in ("none", "HIPT"):
        assert got_t is None and want_t is None
        return
    for b in batches:
        got, want = got_t(b.copy()), want_t(b.copy())
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    if preset == "macenko":
        assert got_t.failures == want_t.failures == 2
    with pytest.raises(ValueError):
        taug.build_transform("nope")
