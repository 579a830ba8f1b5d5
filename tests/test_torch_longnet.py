"""Prov-GigaPath's slide encoder on the port (models/longnet.py,
ops/dilated_attention.py, ``gigapath_slide``) against the plain reference
of the benchmark (port_bench/reference/longnet.py, which follows
torchscale's rearranges and imports nothing of the port), on the CPU from
one set of seeded weights: small widths over the bag sizes that reach
every pad and segment case, the published schedule at 16 heads, MAE's
position table, the serve and eval entries and the CLI, train's refusal,
and planted faults of the dilated attention that the comparison catches.
"""
import json
import os
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from hipt_abmil_atec23_tpu_torch import cli
from hipt_abmil_atec23_tpu_torch.data.bags import FeatureBagStore
from hipt_abmil_atec23_tpu_torch.engine import serve
from hipt_abmil_atec23_tpu_torch.models import longnet as LN
from hipt_abmil_atec23_tpu_torch.models.abmil import (
    MIL_MODEL_TYPES, build_mil_model)
from hipt_abmil_atec23_tpu_torch.ops import dilated_attention as DA
from hipt_abmil_atec23_tpu_torch.utils import logging as lg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from port_bench.reference import longnet as REF  # noqa: E402

SMALL = [(8, 1), (16, 2), (32, 4)]
# f32 on both sides, the same function in another order (the reference's
# rearranges and one softmax per segment against the port's gathers): 12
# layers' worth of f32 rounding sits near 1e-6 of the embedding
TOL = 2e-5


def make_model(dim, heads, depth, schedule, in_dim=32, seed=0, n_classes=2,
               **kw):
    """A head whose every leaf is random (LayerNorm weights around 1),
    with Linear weights spread enough that attention is selective."""
    model = LN.GigaPathSlide(n_classes=n_classes, in_dim=in_dim, dim=dim,
                             depth=depth, heads=heads, schedule=schedule,
                             **kw)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            z = torch.randn(p.shape, generator=g)
            if "norm" in name or "ln" in name:
                p.copy_(1 + 0.1 * z if name.endswith("weight") else 0.02 * z)
            elif name.endswith("bias") or "cls_token" in name:
                p.copy_(0.02 * z)
            else:
                p.copy_(z * 1.5 / p.shape[1] ** 0.5)
    return model.eval()


def ref_cfg(dim, heads, depth, schedule):
    return dict(embed_dim=dim, num_heads=heads, depth=depth,
                segment_length=[w for w, _ in schedule],
                dilated_ratio=[r for _, r in schedule], tile_size=256,
                slide_ngrids=1000, ln_eps=1e-5, norm_eps=1e-6)


def bag_of(n, in_dim=32, seed=0):
    g = torch.Generator().manual_seed(seed)
    bag = torch.randn(n, in_dim, generator=g)
    coords = torch.stack([torch.randint(0, 60000, (n,), generator=g),
                          torch.randint(0, 60000, (n,), generator=g)], 1)
    return bag, coords


def gaps(model, bag, coords, cfg):
    """(embedding, logit, token) gaps of the port to the reference: the
    relative L2 gap of the slide embedding, the worst logit gap over the
    largest logit, the worst relative L2 gap of a last-layer token."""
    with torch.no_grad():
        out = model(bag, coords)
        emb, logits, tokens = REF.gigapath_slide(
            bag, coords, {k: v.float() for k, v in
                          model.state_dict().items()}, cfg)
    e, t = out.extras["slide_embedding"][0], out.extras["tokens"]
    return (((e - emb).norm() / emb.norm()).item(),
            ((out.logits[0] - logits).abs().max()
             / logits.abs().max()).item(),
            ((t - tokens).norm(dim=1) / tokens.norm(dim=1)).max().item())


@pytest.fixture(scope="module")
def small():
    return make_model(64, 4, 2, SMALL), ref_cfg(64, 4, 2, SMALL)


@pytest.mark.parametrize("n", [1, 2, 7, 8, 9, 31, 33, 100])
def test_port_matches_reference_small(n, small):
    """D 64, 4 heads, 2 layers, branches (8, 1), (16, 2), (32, 4): a bag
    below every w, at and past it, tokens not a multiple of r."""
    model, cfg = small
    feat, logit, token = gaps(model, *bag_of(n, seed=n), cfg)
    assert feat < TOL and logit < TOL and token < TOL, (feat, logit, token)


@pytest.mark.parametrize("n", [1100, 6000])
def test_port_matches_reference_published_schedule(n):
    """The published five branches at 16 heads of 6: 1,101 tokens are one
    segment of every branch but the first, 6,001 cut (5792, 2) in two."""
    model = make_model(96, 16, 1, LN.PUBLISHED_SCHEDULE, seed=1)
    feat, logit, token = gaps(model, *bag_of(n, seed=n),
                              ref_cfg(96, 16, 1, LN.PUBLISHED_SCHEDULE))
    assert feat < TOL and logit < TOL and token < TOL, (feat, logit, token)


@pytest.mark.parametrize("n,schedule", [
    (1, SMALL), (9, SMALL), (100, SMALL), (33, [(8, 1), (12, 4)]),
    (300, [(64, 1), (96, 2), (256, 4), (1024, 16)])])
def test_plain_op_matches_the_reference_op(n, schedule):
    """The op alone, q, k, v [N, 16, 8] f32: the port's plain version and
    the reference's rearranges agree per element (f32 sums in other
    orders)."""
    g = torch.Generator().manual_seed(n)
    q, k, v = (torch.randn(n, 16, 8, generator=g) for _ in range(3))
    got = DA.dilated_attention(q, k, v, schedule)
    want = REF.dilated_attention(q, k, v, schedule)
    assert got.shape == (n, 128)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_position_rows_are_maes_table():
    """The model's rows and the reference's, for every cell of a 40 x 40
    grid, against MAE's whole table, bit for bit; row 0 (the CLS) is
    zeros."""
    table = REF.mae_pos_table(64, 40)
    enc = LN.LongNetViT(in_dim=8, dim=64, depth=1, heads=4,
                        schedule=SMALL, ngrids=40)
    i = torch.arange(1600)
    coords = torch.stack([i // 40 * 256 + 17, i % 40 * 256 + 255], 1)
    assert torch.equal(enc.position_rows(coords), table[1:])
    assert torch.equal(REF.pos_rows(i + 1, 64, 40), table[1:])
    assert torch.equal(REF.pos_rows(torch.tensor([0]), 64, 40), table[:1])
    with pytest.raises(ValueError, match="outside"):
        enc.position_rows(torch.tensor([[40 * 256, 0]]))


def test_published_shapes():
    assert LN.PUBLISHED_SCHEDULE == ((1024, 1), (5792, 2), (32768, 4),
                                     (185363, 8), (1048576, 16))
    model = build_mil_model("gigapath_slide")
    assert "gigapath_slide" in MIL_MODEL_TYPES
    assert sum(p.numel() for p in model.parameters()) == 86_332_418
    keys = set(model.state_dict())
    for k in ("slide_encoder.patch_embed.proj.weight",
              "slide_encoder.cls_token", "slide_encoder.norm.weight",
              "slide_encoder.encoder.layer_norm.bias",
              "slide_encoder.encoder.layers.11.self_attn.inner_attn_ln.weight",
              "slide_encoder.encoder.layers.0.ffn.ffn_layernorm.weight",
              "slide_encoder.encoder.layers.3.self_attn.q_proj.weight",
              "classifier.0.weight"):
        assert k in keys, k
    bf16 = build_mil_model("gigapath_slide", dtype=torch.bfloat16)
    dtypes = {n: p.dtype for n, p in bf16.named_parameters()}
    assert dtypes["slide_encoder.encoder.layers.0.ffn.fc1.weight"] == \
        torch.bfloat16
    assert dtypes["slide_encoder.encoder.layers.0.ffn.ffn_layernorm.weight"] \
        == torch.float32
    assert dtypes["classifier.0.weight"] == torch.float32


def test_refuses_what_it_does_not_take():
    q = torch.zeros(10, 4, 8)
    with pytest.raises(ValueError):
        DA.dilated_attention(q, q, q, [(8, 3)])        # r does not divide H
    with pytest.raises(ValueError):
        DA.dilated_attention(q, q, q, [(6, 4)])        # N > w, r does not
    with pytest.raises(ValueError):                    # divide w
        DA.dilated_attention(q, q[:9], q, SMALL)
    with pytest.raises(ValueError):
        DA.dilated_attention(q, q, q, [])
    with pytest.raises(ValueError):
        make_model(64, 4, 1, SMALL)(torch.zeros(3, 32), torch.zeros(3, 3))


def test_kernel_plan_covers_every_selected_position():
    """The launch's descriptor: each branch's programs in one range, the
    heaviest first, and its query blocks covering every selected position
    of every segment and head group."""
    for n in (1, 2049, 11081, 32769):
        rows, programs, cols = DA.kernel_plan(n, LN.PUBLISHED_SCHEDULE, 16,
                                              128)
        assert cols == 16 + 8 + 4 + 2 + 1
        firsts = [r[5] for r in rows]
        assert firsts == sorted(firsts) and firsts[0] == 0
        keys = [r[2] for r in rows]
        assert keys == sorted(keys, reverse=True)
        assert programs == sum(r[3] * 16 * r[4] for r in rows)
        for wp, r, length, segs, tiles, _, hg, _ in rows:
            assert tiles * 128 >= length and hg * r == 16
            assert segs * wp >= n and (segs - 1) * wp < n


@pytest.mark.parametrize("n", [1, 2, 7, 33, 100, 2049, 11081])
def test_branch_pairs_count_the_tokens_of_each_group(n):
    """Pairs among each (segment, head group)'s tokens, counted from the
    selected positions one by one: the pads count nothing."""
    for w, r in SMALL + list(LN.PUBLISHED_SCHEDULE):
        _, real = DA.branch_index(n, w, r, 16)
        assert DA.branch_pairs(n, w, r, 16) == int((real.sum(-1) ** 2).sum())


@pytest.mark.parametrize("ahead", [0, 1, 3])
def test_score_stream_keeps_order_and_draws_lazily(small, ahead,
                                                   monkeypatch):
    """Answers in the slides' order, equal to one score_with_coords call
    each; the stream draws at most ``SCORE_AHEAD`` + 1 slides before its
    first answer."""
    monkeypatch.setattr(serve, "SCORE_AHEAD", ahead)
    model, _ = small
    state = serve.ServeState(device=torch.device("cpu"), model=model)
    bags = [bag_of(n, seed=n) for n in (5, 40, 17, 64, 9)]
    drawn = []

    def slides():
        for i, (bag, coords) in enumerate(bags):
            drawn.append(i)
            yield i, bag.numpy(), coords.numpy()

    stream = serve.score_stream(state, slides())
    key, first = next(stream)
    assert key == 0 and len(drawn) == min(ahead + 1, len(bags))
    got = [(key, first)] + list(stream)
    assert [k for k, _ in got] == list(range(len(bags)))
    for (_, logits), (bag, coords) in zip(got, bags):
        want = serve.score_with_coords(state, bag.numpy(), coords.numpy())
        torch.testing.assert_close(logits, want.logits.float(), rtol=0,
                                   atol=0)


def test_spans_and_counts_while_profiled(small):
    model, _ = small
    state = serve.ServeState(device=torch.device("cpu"), model=model)
    bag, coords = bag_of(40, seed=3)
    lg.clear_spans()
    serve.score_with_coords(state, bag.numpy(), coords.numpy())
    assert lg.recorded_spans() == [] and lg.recorded_counts() == []
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        out = serve.score_with_coords(state, bag.numpy(), coords.numpy())
    names = [s.name for s in lg.recorded_spans()]
    assert names == ["longnet.h2d", "longnet.embed", "longnet.layers"]
    assert all(s.rows == 40 for s in lg.recorded_spans())
    counts = {c.name: c.values for c in lg.recorded_counts()}
    assert counts["longnet.pairs"] == tuple(
        DA.branch_pairs(41, w, r, 4) for w, r in SMALL)
    assert counts["longnet.kernel"] == (0, 0)      # the plain version
    assert out.a_raw is None
    torch.testing.assert_close(out.y_prob, torch.softmax(out.logits, -1))
    lg.clear_spans()


def test_serve_entry_refuses_tiles_off_the_grid(small):
    model, _ = small
    state = serve.ServeState(device=torch.device("cpu"), model=model)
    bag, coords = bag_of(4)
    coords[0, 0] = 1000 * 256
    with pytest.raises(ValueError, match="outside"):
        serve.score_with_coords(state, bag, coords)


# --------------------------------------------------- planted faults
def _drop_branch(b):
    def fn(q, k, v, schedule):
        return DA.dilated_attention_reference(
            q, k, v, [x for i, x in enumerate(schedule) if i != b])
    return fn


def _shifted_index(n, w, r, heads, device=None):
    """Head group j takes the positions = j + 1 (mod r)."""
    wp, segs, length = DA.branch_shape(n, w, r)
    group = (torch.arange(heads) // (heads // r) + 1) % r
    in_seg = group[:, None] + r * torch.arange(length)[None, :]
    rows = torch.arange(segs)[:, None, None] * wp + in_seg
    real = (in_seg < wp) & (rows < n)
    return torch.where(real, rows, 0), real


def _masked_branch(q, k, v, w, r):
    """A branch whose zero-padded keys are masked out of the softmax."""
    n, heads, d = q.shape
    rows, real = DA.branch_index(n, w, r, heads)
    hh = torch.arange(heads)[None, :, None].expand_as(rows)
    qs, ks, vs = (torch.where(real[..., None], x[rows, hh].float(), 0.0)
                  .flatten(0, 1) for x in (q, k, v))
    s = (qs @ ks.transpose(1, 2)) * d ** -0.5
    s = s.masked_fill(~real.flatten(0, 1)[:, None, :], float("-inf"))
    o = torch.softmax(s, -1) @ vs
    o_full = torch.zeros(n, heads, d)
    lse_full = torch.full((n, heads), DA.UNSELECTED_LSE)
    keep = real.flatten()
    o_full[rows.flatten()[keep], hh.flatten()[keep]] = o.view(-1, d)[keep]
    lse_full[rows.flatten()[keep], hh.flatten()[keep]] = \
        torch.logsumexp(s, -1).view(-1)[keep]
    return o_full, lse_full


@pytest.mark.parametrize("fault", ["drop0", "drop1", "drop2", "shift",
                                   "masked"])
def test_planted_faults_fail_the_comparison(fault, small, monkeypatch):
    """Each fault of the dilated attention, planted in the port's plain
    path, moves the slide embedding and the last layer's tokens far past
    the tolerance on a bag whose CLS reaches pads through its one global
    branch (21 tiles: 22 tokens; (8, 1) and (16, 2) pad their last
    segment, (32, 4) its groups 2, 3)."""
    model, cfg = small
    if fault.startswith("drop"):
        monkeypatch.setattr(LN, "dilated_attention",
                            _drop_branch(int(fault[-1])))
    elif fault == "shift":
        monkeypatch.setattr(DA, "branch_index", _shifted_index)
    else:
        monkeypatch.setattr(DA, "_branch_plain", _masked_branch)
    feat, _, token = gaps(model, *bag_of(21, seed=21), cfg)
    assert feat > 100 * TOL and token > 100 * TOL, (feat, token)


# ------------------------------------------------------------- CLI
def test_train_refuses_gigapath_slide(tmp_path):
    with pytest.raises(SystemExit, match="F.6"):
        cli.main(["train", "--csv_path", str(tmp_path / "x.csv"),
                  "--feat_dir", str(tmp_path), "--results_dir",
                  str(tmp_path), "--model_type", "gigapath_slide",
                  "--device", "cpu"])


@pytest.fixture(scope="module")
def slide(tmp_path_factory):
    from hipt_abmil_atec23_tpu.slideio import native
    from hipt_abmil_atec23_tpu.slideio.synthetic import write_synthetic_slide
    d = tmp_path_factory.mktemp("longnet_cli")
    (d / "inbox").mkdir()
    write_synthetic_slide(str(d / "inbox" / "t.tif"), 1024, 1024,
                          n_levels=2, compression=native.COMPRESSION_DEFLATE,
                          seed=0)
    return d


def test_cli_serve_scores_with_coords(slide, tmp_path):
    """`serve --once --model_type gigapath_slide` on a ResNet-18 bag (512-d,
    f32): the record has no top regions and no blockmap, and its
    probabilities are the head's own on the saved bag and coords."""
    ckpt = str(tmp_path / "gp.pt")
    head = build_mil_model("gigapath_slide", in_dim=512)
    torch.save(head.state_dict(), ckpt)
    out = tmp_path / "o"
    assert cli.main([
        "serve", "--encoder", "resnet18", "--float32", "--model_type",
        "gigapath_slide", "--slide_dir", str(slide / "inbox"), "--out_dir",
        str(out), "--ckpt", ckpt, "--patch_size", "256", "--use_otsu",
        "--a_t", "1", "--batch_size", "4", "--once", "--min_stable_s", "0",
        "--save_features", "--device", "cpu"]) == 0
    rec = json.load(open(out / "results" / "t.json"))
    assert rec["status"] == "done" and rec["n_regions"] > 0
    assert "top_regions" not in rec
    assert not (out / "results" / "t_blockmap.h5").exists()
    feats, coords = FeatureBagStore(str(out / "features")).load_with_coords(
        "t")
    with torch.no_grad():
        want = head.eval()(torch.from_numpy(feats), torch.from_numpy(coords))
    np.testing.assert_allclose(rec["p"], want.y_prob[0].numpy(), atol=1e-6)


def test_cli_eval_scores_whole_bags_with_coords(tmp_path):
    """`eval --model_type gigapath_slide --splits all` reads each bag with
    its coords from the h5 store and the fold's .pt, and writes the head's
    own probabilities per slide."""
    store = FeatureBagStore(str(tmp_path / "f"))
    rows = []
    for i in range(4):
        bag, coords = bag_of(20 + 7 * i, seed=i)
        store.save(f"s{i}", bag.numpy(), coords=coords.numpy(),
                   formats=("h5",))
        rows.append({"case_id": f"c{i}", "slide_id": f"s{i}",
                     "label": ("invalid", "effective")[i % 2]})
    pd.DataFrame(rows).to_csv(tmp_path / "labels.csv", index=False)
    head = make_model(768, 16, 12, LN.PUBLISHED_SCHEDULE, seed=4)
    (tmp_path / "m").mkdir()
    torch.save(head.state_dict(), tmp_path / "m" / "s_0_checkpoint.pt")
    assert cli.main([
        "eval", "--csv_path", str(tmp_path / "labels.csv"), "--feat_dir",
        str(tmp_path / "f"), "--models_dir", str(tmp_path / "m"),
        "--save_dir", str(tmp_path / "e"), "--splits", "all", "--k", "1",
        "--folds", "0", "--model_type", "gigapath_slide", "--device",
        "cpu"]) == 0
    got = pd.read_csv(tmp_path / "e" / "fold_0.csv")
    for _, row in got.iterrows():
        bag, coords = store.load_with_coords(row["slide_id"])
        with torch.no_grad():
            p = head(torch.from_numpy(bag), torch.from_numpy(coords)).y_prob
        np.testing.assert_allclose([row["p_0"], row["p_1"]], p[0].numpy(),
                                   atol=1e-6)
