"""Online feature extraction (hipt_abmil_atec23_tpu_torch/data/online.py and
the CLI's ``train --extract_features``) held against the JAX package's
(data/online.py, tests/test_online_encoding.py) on the CPU.

Eight synthetic DEFLATE TIFFs tiled at 64 px (a small patch keeps the
full-width ResNet-18 cheap on the CPU), one reference-layout ResNet-18
.pth loaded by both packages' encoders in f32. ``get_bag`` takes the JAX
package's draws from one numpy Generator (left in the same state) and its
features are within 1e-4 relative L2 per patch (f32 arithmetic in another
order). Training runs both packages from one initial head (the JAX init,
carried into a .msgpack and a .pt; continue_training; dropout off):
per-epoch losses and test probabilities within 1e-5, AUCs within 1e-6, as
tests/test_torch_train.py holds the store-backed fold."""
import os

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from hipt_abmil_atec23_tpu import cli as jcli
from hipt_abmil_atec23_tpu.data import online as jonline
from hipt_abmil_atec23_tpu.engine import checkpoint as jckpt
from hipt_abmil_atec23_tpu.engine import encode as jenc
from hipt_abmil_atec23_tpu.engine import train as jtrain
from hipt_abmil_atec23_tpu.slideio import native
from hipt_abmil_atec23_tpu.slideio.synthetic import write_synthetic_slide
from hipt_abmil_atec23_tpu.utils import config as jcfg
from hipt_abmil_atec23_tpu_torch import cli
from hipt_abmil_atec23_tpu_torch.data import online
from hipt_abmil_atec23_tpu_torch.engine import encode
from hipt_abmil_atec23_tpu_torch.engine import train as ptrain
from hipt_abmil_atec23_tpu_torch.engine.checkpoint import ckpt_path
from hipt_abmil_atec23_tpu_torch.models import resnet
from hipt_abmil_atec23_tpu_torch.models.convert import mil_state_dict_from_jax
from hipt_abmil_atec23_tpu_torch.slideio.patching import (
    coords_attrs, enumerate_coords, save_coords_h5)
from hipt_abmil_atec23_tpu_torch.slideio.reader import TiffSlide
from hipt_abmil_atec23_tpu_torch.slideio.seg import segment_tissue
from hipt_abmil_atec23_tpu_torch.utils import config as pcfg
from test_torch_encoders import jax_resnet18_encoder

REL = 1e-4
TOL = 1e-5
PATCH = 64
N_SLIDES = 8


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Slides, their 64 px coords h5s under ``patches/``, a ResNet-18 .pth
    and both packages' f32 encoders on it."""
    d = tmp_path_factory.mktemp("online")
    coords_dir = d / "patches"
    coords_dir.mkdir()
    tile = pcfg.TileConfig(patch_size=PATCH, step_size=PATCH,
                           seg=pcfg.SegConfig(use_otsu=True, a_t=1, close=4))
    ids, paths = [], {}
    for i in range(N_SLIDES):
        sid = f"on{i}"
        path = str(d / f"{sid}.tif")
        write_synthetic_slide(path, 1536, 1024, n_levels=3,
                              compression=native.COMPRESSION_DEFLATE, seed=i)
        slide = TiffSlide(path)
        coords = enumerate_coords(slide, segment_tissue(slide, tile.seg),
                                  tile)
        assert len(coords) > 16
        save_coords_h5(str(coords_dir / f"{sid}.h5"), coords,
                       coords_attrs(slide, tile, sid, str(coords_dir)))
        slide.close()
        ids.append(sid)
        paths[sid] = path
    ckpt = str(d / "r18.pth")
    torch.save(resnet.resnet18(generator=torch.Generator().manual_seed(0))
               .state_dict(), ckpt)
    jax_enc = jax_resnet18_encoder(ckpt, 8)
    port_enc = encode.build_encoder(pcfg.EncoderConfig(
        model_type="resnet18", batch_size=8, dtype="float32",
        resnet_ckpt=ckpt), device="cpu")
    labels = np.arange(N_SLIDES, dtype=np.int32) % 2
    return dict(dir=d, ids=ids, paths=paths, coords_dir=str(coords_dir),
                ckpt=ckpt, labels=labels, jax_enc=jax_enc,
                port_enc=port_enc)


def _datasets(s, jbag, pbag, idx=None):
    idx = range(N_SLIDES) if idx is None else idx
    ids = [s["ids"][i] for i in idx]
    labels = s["labels"][list(idx)]
    return (jonline.OnlineEncodingBagDataset(
                ids, labels, s["jax_enc"], s["paths"], s["coords_dir"], jbag),
            online.OnlineEncodingBagDataset(
                ids, labels, s["port_enc"], s["paths"], s["coords_dir"],
                pbag))


def _rel(got, want):
    return np.linalg.norm(got - want, axis=1) / np.linalg.norm(want, axis=1)


def test_get_bag_draws_like_jax(setup):
    """Subsampled training draws (with Gaussian perturbation), an eval
    draw, and the pad size: the same coords and noise as the JAX package
    (the Generators end in one state), the features within 1e-4."""
    bag = dict(max_patches_per_slide=12, perturb_variance=0.1)
    jds, pds = _datasets(setup, jcfg.BagConfig(**bag), pcfg.BagConfig(**bag))
    jr, pr = np.random.default_rng(5), np.random.default_rng(5)
    for idx, train in ((0, True), (3, True), (5, False)):
        want = jds.get_bag(idx, jr, train=train)
        got = pds.get_bag(idx, pr, train=train)
        assert got.shape == want.shape == (12, 512)
        assert _rel(got, want).max() <= REL
    assert jr.bit_generator.state == pr.bit_generator.state
    assert pds.pad_size() == jds.pad_size() == 16
    with pytest.raises(NotImplementedError, match="on demand"):
        pds._full_bag(setup["ids"][0])
    jds.close()
    pds.close()


def test_feature_gather_encodes_each_patch_once(setup, monkeypatch):
    """OnlineFeatureGather.take: the JAX package's features for the asked
    patches, each encoded once; a second take of cached patches makes no
    encoder call. build_feature_gathers opens every slide's gather."""
    s = setup
    gathers = online.build_feature_gathers(s["paths"], s["coords_dir"],
                                           s["port_enc"], s["ids"][:2])
    g = gathers[s["ids"][1]]
    jg = jonline.build_feature_gathers(s["paths"], s["coords_dir"],
                                       s["jax_enc"], s["ids"][1:2])[
        s["ids"][1]]
    assert len(g) == len(jg) and g.shape == (len(jg), 512)
    assert np.array_equal(g.coords, jg.coords)
    calls = []
    enc = g.encoder
    monkeypatch.setattr(enc, "apply",
                        lambda x, _f=enc.apply: calls.append(len(x))
                        or _f(x))
    idxs = [7, 2, 7, 11]
    first = g.take(idxs)
    assert calls == [8] and sorted(g._cache) == [2, 7, 11]
    again = g.take([11, 2])
    assert calls == [8]
    assert np.array_equal(again, first[[3, 1]])
    assert _rel(first, jg.take(idxs)).max() <= REL
    with pytest.raises(ValueError, match="axis"):
        g.take([0], axis=1)
    for gather in list(gathers.values()) + [jg]:
        gather.slide.close()


def _cfgs(results):
    d = {"task": {"n_classes": 2, "label_dict": {"0": 0, "1": 1}},
         "bags": {"max_patches_per_slide": 8, "batch_size": 1},
         "model": {"model_type": "clam_sb",
                   "model_size": "tinier_resnet18", "no_inst_cluster": True},
         "train": {"lr": 1e-3, "reg": 1e-5, "max_epochs": 2,
                   "early_stopping": False, "continue_training": True,
                   "seed": 0}}
    jc = jcfg.ExperimentConfig.from_dict(d)
    pc = pcfg.ExperimentConfig.from_dict(d)
    jc.results_dir, pc.results_dir = (str(results / k)
                                      for k in ("jax", "port"))
    return jc, pc


def _seed_heads(jc, pc, folds, n_pad):
    """One JAX init per fold, as the JAX package's .msgpack and the
    port's .pt under each results_dir (continue_training loads them)."""
    counts = np.array([N_SLIDES // 2, N_SLIDES // 2])
    for fold in folds:
        params = jtrain.build_step_fns(jc, counts, n_pad, 512).init_params(
            jax.random.PRNGKey(fold + 7))
        jckpt.save_params(jckpt.ckpt_path(jc.results_dir, fold), params)
        os.makedirs(pc.results_dir, exist_ok=True)
        torch.save(mil_state_dict_from_jax(params),
                   ckpt_path(pc.results_dir, fold))


def test_train_fold_over_online_datasets_matches_jax(setup, tmp_path):
    jc, pc = _cfgs(tmp_path)
    sel = (range(0, 4), range(4, 6), range(6, 8))
    jds, pds = zip(*(_datasets(setup, jc.bags, pc.bags, s) for s in sel))
    _seed_heads(jc, pc, [0], 8)
    counts = np.array([4, 4])
    want = jtrain.train_fold(jc, 0, *jds, counts, feat_dim=512,
                             verbose=False)
    got = ptrain.train_fold(pc, 0, *pds, counts, feat_dim=512,
                            verbose=False, device="cpu")
    assert len(got.history) == len(want.history) == 2
    for g, w in zip(got.history, want.history):
        for k in ("train_loss", "val_loss", "train_acc"):
            assert abs(g[k] - w[k]) <= TOL, (k, g, w)
    np.testing.assert_allclose(got.test_probs, want.test_probs, atol=TOL)
    assert got.test_slide_ids == want.test_slide_ids
    for ds in jds + pds:
        ds.close()


def test_cli_train_extract_features_matches_jax(setup, tmp_path,
                                                monkeypatch):
    """Both CLIs' ``train --extract_features`` over three folds from one
    initial head per fold (the f32 encoders above stand in for
    build_encoder, whose CLI default is bf16): the same summary and fold
    CSVs, AUCs within 1e-6 and probabilities within 1e-5."""
    s = setup
    monkeypatch.setattr(jenc, "build_encoder", lambda cfg: s["jax_enc"])
    monkeypatch.setattr(encode, "build_encoder",
                        lambda cfg, device: s["port_enc"])
    csv = str(tmp_path / "labels.csv")
    pd.DataFrame({"case_id": s["ids"], "slide_id": s["ids"],
                  "label": ["invalid" if lab == 0 else "effective"
                            for lab in s["labels"]]}).to_csv(csv,
                                                             index=False)
    jc, pc = _cfgs(tmp_path)
    _seed_heads(jc, pc, range(3), 8)
    data = str(s["dir"])
    argv = ["train", "--task", "treatment", "--csv_path", csv,
            "--feat_dir", str(tmp_path / "unused"), "--extract_features",
            "--data_h5_dir", data, "--data_slide_dir", data,
            "--model_architecture", "resnet18", "--model_size",
            "tinier_resnet18", "--no_inst_cluster", "--k", "3",
            "--max_epochs", "2", "--min_epochs", "1", "--no_early_stopping",
            "--max_patches_per_slide", "8", "--seed", "0",
            "--continue_training", "--resnet_ckpt", s["ckpt"]]
    jcli.main(argv + ["--results_dir", jc.results_dir])
    assert cli.main(argv + ["--results_dir", pc.results_dir,
                            "--device", "cpu"]) == 0
    want, got = (pd.read_csv(os.path.join(c.results_dir, "summary.csv"))
                 for c in (jc, pc))
    assert list(got.columns) == list(want.columns)
    assert list(got["folds"]) == list(want["folds"]) == [0, 1, 2]
    for col in ("test_auc", "val_auc", "test_acc", "val_acc"):
        np.testing.assert_allclose(got[col], want[col], rtol=0, atol=1e-6)
    for fold in range(3):
        w, g = (pd.read_csv(os.path.join(c.results_dir, f"fold_{fold}.csv"))
                for c in (jc, pc))
        assert list(g["slide_id"]) == list(w["slide_id"])
        assert list(g["Y"]) == list(w["Y"])
        np.testing.assert_allclose(g[["p_0", "p_1"]], w[["p_0", "p_1"]],
                                   rtol=0, atol=TOL)
