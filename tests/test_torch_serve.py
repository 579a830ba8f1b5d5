"""The slice end to end: the port's serve_once (tile -> HIPT_4K encode ->
CLAM_SB) held against the JAX package's serve_once on the same slides,
weights and checkpoint.

Two synthetic slides: a YCbCr 4:2:0 JPEG one (plane rung) and a DEFLATE one
(RGB rung). Both packages run a narrow HIPT at f32 on 512 px regions
(the JAX side through a hand-built Encoder without a DCT entry, so both ride
the same rungs) and load one reference-layout .pt CLAM_SB checkpoint."""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipt_abmil_atec23_tpu.engine import encode as jenc
from hipt_abmil_atec23_tpu.engine import serve as jserve
from hipt_abmil_atec23_tpu.explain.heatmaps import load_blockmap
from hipt_abmil_atec23_tpu.models import CLAM_SB as JaxCLAM
from hipt_abmil_atec23_tpu.models import hipt as jhipt
from hipt_abmil_atec23_tpu.models.convert import clam_params_to_torch
from hipt_abmil_atec23_tpu.ops.yuv import yuv_planes_to_rgb
from hipt_abmil_atec23_tpu.slideio import native
from hipt_abmil_atec23_tpu.slideio.patching import enumerate_coords
from hipt_abmil_atec23_tpu.slideio.reader import open_slide
from hipt_abmil_atec23_tpu.slideio.seg import segment_tissue
from hipt_abmil_atec23_tpu.slideio.synthetic import write_synthetic_slide
from hipt_abmil_atec23_tpu.utils.config import (
    EncoderConfig, ModelConfig, SegConfig, TileConfig)
from hipt_abmil_atec23_tpu_torch.engine import encode, serve
from hipt_abmil_atec23_tpu_torch.models.convert import (
    hipt_state_dict_from_jax)
from test_torch_hipt import narrow_jax_hipt, narrow_params, narrow_port_hipt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 8  # > regions per slide: one batch each, so JAX's rung selector
           # never gets a wire estimate and both packages keep the rung


def _cfg(slide_dir, out_dir, ckpt):
    return jserve.ServeConfig(
        slide_dir=str(slide_dir), out_dir=str(out_dir), ckpt_path=ckpt,
        encoder=EncoderConfig(model_type="HIPT_4K", batch_size=BATCH,
                              dtype="float32"),
        model=ModelConfig(model_type="clam_sb", model_size="hipt_smaller"),
        tile=TileConfig(patch_size=512, step_size=512,
                        seg=SegConfig(use_otsu=True, close=4, a_t=1)),
        n_classes=2, top_k=3, min_stable_s=0.0)


def _jax_encoder(params):
    model = narrow_jax_hipt(jnp.float32)

    @jax.jit
    def fwd(v, x):
        return model.apply(v, jhipt.hipt_eval_normalize(x))

    @jax.jit
    def fwd_yuv(v, y, cb, cr):
        return model.apply(v, yuv_planes_to_rgb(y, cb, cr) / 127.5 - 1.0)

    v = jax.device_put(params)
    return jenc.Encoder(name="HIPT_4K", apply=partial(fwd, v),
                        batch_size=BATCH, input_size=512, feat_dim=192,
                        variables=v, apply_yuv=partial(fwd_yuv, v),
                        apply_dct=None, jit_fwd=fwd, jit_fwd_yuv=fwd_yuv)


def _port_encoder(params):
    model = narrow_port_hipt(torch.float32)
    return encode.build_encoder(
        EncoderConfig(model_type="HIPT_4K", batch_size=BATCH,
                      dtype="float32"),
        device="cpu", model=model,
        state_dict=hipt_state_dict_from_jax(params))


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_serve")
    slide_dir = d / "slides"
    slide_dir.mkdir()
    write_synthetic_slide(str(slide_dir / "ycc.tif"), 1536, 1536,
                          n_levels=3, ycbcr420=True, seed=1)
    write_synthetic_slide(str(slide_dir / "rgb.tif"), 1536, 1536,
                          n_levels=3, compression=native.COMPRESSION_DEFLATE,
                          seed=2)
    rng = np.random.default_rng(5)
    clam = JaxCLAM(size_arg="hipt_smaller", n_classes=2)
    cp = clam.init(jax.random.PRNGKey(0), jnp.zeros((8, 192)), None)
    cp = jax.tree.map(
        lambda a: a + 0.2 * rng.normal(size=a.shape).astype(np.float32), cp)
    ckpt = str(d / "clam.pt")
    torch.save(clam_params_to_torch(cp), ckpt)

    params = narrow_params(seed=2)
    jcfg = _cfg(slide_dir, d / "out_jax", ckpt)
    tcfg = _cfg(slide_dir, d / "out_torch", ckpt)
    jrecs = jserve.serve_once(
        jcfg, jserve.ServeState(encoder=_jax_encoder(params)), verbose=False)
    enc = _port_encoder(params)
    rungs = []  # which entry each batch rode
    rgb, yuv = enc.apply, enc.apply_yuv
    enc.apply = lambda x: rungs.append("rgb") or rgb(x)
    enc.apply_yuv = lambda *p: rungs.append("yuv") or yuv(*p)
    state = serve.ServeState(device=torch.device("cpu"), encoder=enc)
    trecs = serve.serve_once(tcfg, state, verbose=False)
    assert sorted(rungs) == ["rgb", "yuv"]  # one batch per slide
    return d, slide_dir, ckpt, jcfg, tcfg, jrecs, trecs, state


def test_serve_matches_jax_per_slide(served):
    """Per slide: y_hat, n_regions and top-region coords equal; p and the
    top-region scores within 1e-4 (f32 on both sides)."""
    _, _, _, _, _, jrecs, trecs, _ = served
    jby = {r["slide_id"]: r for r in jrecs}
    tby = {r["slide_id"]: r for r in trecs}
    assert set(tby) == set(jby) == {"ycc", "rgb"}
    for sid, j in jby.items():
        t = tby[sid]
        assert t["status"] == j["status"] == "done"
        assert t["y_hat"] == j["y_hat"] and t["n_regions"] == j["n_regions"]
        assert t["n_regions"] > 1
        np.testing.assert_allclose(t["p"], j["p"], rtol=0, atol=1e-4)
        assert abs(sum(t["p"]) - 1) < 1e-5
        assert [r[:2] for r in t["top_regions"]] == \
            [r[:2] for r in j["top_regions"]]
        np.testing.assert_allclose([r[2] for r in t["top_regions"]],
                                   [r[2] for r in j["top_regions"]],
                                   rtol=0, atol=1e-4)


def test_serve_outputs_and_journal_match_jax(served):
    """Same journal statuses, same per-slide JSON schema, blockmaps with
    equal coords and scores within 1e-4, the same predictions.jsonl
    slides; a second drain is a no-op for both."""
    _, _, _, jcfg, tcfg, _, _, state = served
    assert serve.load_journal(tcfg) == jserve.load_journal(jcfg) == {
        "ycc": "done", "rgb": "done"}
    for sid in ("ycc", "rgb"):
        paths = [os.path.join(c.out_dir, "results", f"{sid}.json")
                 for c in (jcfg, tcfg)]
        jrec, trec = (json.load(open(p)) for p in paths)
        assert set(trec) == set(jrec)
        jc, js = load_blockmap(os.path.join(jcfg.out_dir, "results",
                                            f"{sid}_blockmap.h5"))
        tc, ts = load_blockmap(os.path.join(tcfg.out_dir, "results",
                                            f"{sid}_blockmap.h5"))
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_allclose(ts, js, rtol=0, atol=1e-4)
    lines = [[json.loads(l)["slide_id"] for l in
              open(os.path.join(c.out_dir, "predictions.jsonl"))]
             for c in (jcfg, tcfg)]
    assert sorted(lines[1]) == sorted(lines[0])
    assert serve.serve_once(tcfg, state, verbose=False) == []


def test_serve_isolates_a_failing_slide(served, tmp_path, monkeypatch):
    """A stream that dies on one slide falls back to per-slide streams:
    only that slide is journaled 'error', the other is served."""
    _, slide_dir, ckpt, _, tcfg, _, _, state = served
    cfg = dataclasses.replace(tcfg, out_dir=str(tmp_path / "out"))
    real = encode.encode_stream

    def poison(jobs, *a, **k):
        if any(sid == "rgb" for sid, _, _ in jobs):
            raise RuntimeError("decode died on rgb")
        yield from real(jobs, *a, **k)

    monkeypatch.setattr(encode, "encode_stream", poison)
    recs = serve.serve_once(cfg, state, verbose=False)
    assert [r["slide_id"] for r in recs] == ["ycc"]
    assert serve.load_journal(cfg) == {"ycc": "done", "rgb": "error"}
    assert serve.discover(cfg) == ["rgb.tif"]


def test_port_serve_path_imports_no_jax(served, tmp_path):
    """A fresh interpreter runs the port's serve_once on the same slides
    (narrow random HIPT, the same checkpoint) and ends without jax or flax
    in sys.modules."""
    _, slide_dir, ckpt, _, _, _, _, _ = served
    script = textwrap.dedent(f"""
        import dataclasses, json, sys
        import torch
        from hipt_abmil_atec23_tpu.utils.config import (
            EncoderConfig, ModelConfig, SegConfig, TileConfig)
        from hipt_abmil_atec23_tpu_torch.engine.encode import build_encoder
        from hipt_abmil_atec23_tpu_torch.engine.serve import (
            ServeConfig, ServeState, serve_once)
        from hipt_abmil_atec23_tpu_torch.models import vit
        from hipt_abmil_atec23_tpu_torch.models.hipt import make_hipt_encoder
        model = make_hipt_encoder(
            torch.float32,
            dataclasses.replace(vit.VIT_CONFIGS["vit_small"], embed_dim=64,
                                depth=2, num_heads=2),
            vit.ViT4KConfig(input_embed_dim=64, output_embed_dim=192,
                            depth=2, num_heads=2),
            generator=torch.Generator().manual_seed(0))
        enc = EncoderConfig(batch_size=8, dtype="float32")
        cfg = ServeConfig(
            slide_dir={str(slide_dir)!r}, out_dir={str(tmp_path / 'o')!r},
            ckpt_path={ckpt!r}, encoder=enc,
            model=ModelConfig(model_type="clam_sb",
                              model_size="hipt_smaller"),
            tile=TileConfig(patch_size=512, step_size=512,
                            seg=SegConfig(use_otsu=True, close=4, a_t=1)),
            min_stable_s=0.0)
        state = ServeState(device=torch.device("cpu"),
                           encoder=build_encoder(enc, device="cpu",
                                                 model=model))
        recs = serve_once(cfg, state, verbose=False)
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "flax"))
        print(json.dumps({{"done": sorted(r["slide_id"] for r in recs),
                          "jax_modules": loaded}}))
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"done": ["rgb", "ycc"], "jax_modules": []}


def test_encode_stream_matches_jax_across_batches(served):
    """Several batches per slide (batch 3 over 4 and 3 regions, tails
    padded) and an empty job between the slides: the port's encode_stream
    yields the JAX stream's slides in job order with features within 1e-4
    (JAX with its rung selector off, so both keep each slide's rung)."""
    _, slide_dir, _, _, tcfg, _, _, _ = served
    params = narrow_params(seed=2)
    jax_enc = dataclasses.replace(_jax_encoder(params), batch_size=3)
    port_enc = dataclasses.replace(_port_encoder(params), batch_size=3)
    slides = [open_slide(str(slide_dir / f)) for f in ("ycc.tif", "rgb.tif")]
    try:
        jobs = [(sid, s, enumerate_coords(s, segment_tissue(s, tcfg.tile.seg),
                                          tcfg.tile))
                for sid, s in zip(("ycc", "rgb"), slides)]
        jobs.insert(1, ("empty", slides[0], np.zeros((0, 2), np.int64)))
        want = list(jenc.encode_stream(jobs, jax_enc, region_size=512,
                                       adaptive_rungs=False))
        got = list(encode.encode_stream(jobs, port_enc, region_size=512,
                                        prefetch=2))
        assert [s for s, _ in got] == [s for s, _ in want] == \
            ["ycc", "empty", "rgb"]
        for (_, g), (_, w) in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)
        # abandoning the stream mid-way shuts its decode worker down
        stream = encode.encode_stream(jobs, port_enc, region_size=512)
        assert next(stream)[0] == "ycc"
        stream.close()
        assert encode.encode_slide(slides[1], jobs[2][2], port_enc,
                                   region_size=512).shape == (3, 192)
    finally:
        for s in slides:
            s.close()
