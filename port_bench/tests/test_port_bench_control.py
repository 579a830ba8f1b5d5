"""The controls at a size a CPU test run can hold: the plain reference in
the precision below the configuration's (the encoders' bf16 as fp8 e4m3,
the head's f32 as TF32), put in the program's place, fails the cell's
limits. The configurations keep their full widths; only the inputs are
few and small. control.py reads the same numbers on the card at each
cell's own size."""
import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from port_bench import store, weights  # noqa: E402
from port_bench.drivers.serve_stream import reference_features  # noqa
from port_bench.reference import clam  # noqa: E402
from port_bench.reference.precision import exact_f32  # noqa: E402


def load(kind, name):
    with open(os.path.join(ROOT, "port_bench", kind, name + ".json")) as f:
        return json.load(f)


def rel_rows(got, want):
    return ((got - want).norm(dim=1) / want.norm(dim=1)).max().item()


def head_numbers(config, feats, seed):
    w = weights.head_weights(config, seed, "cpu")
    s, lg, _ = clam.clam_sb(feats, w, "f32")
    s8, lg8, _ = clam.clam_sb(feats, w, config["head"]["control_precision"])
    return {"score_err": ((s8 - s).abs().max() / s.abs().max()).item(),
            "logit_err": ((lg8 - lg).abs().max() / lg.abs().max()).item()}


@pytest.mark.parametrize("workload,config,item,region,n", [
    ("hipt4k.serve.plane", "hipt4k_clam_sb_hipt_smaller", 512, 512, 2),
    ("resnet50.serve.plane", "resnet50trunc_clam_sb_small", 256, 512, 8)])
def test_serve_control_fails(workload, config, item, region, n):
    torch.manual_seed(0)
    cfg = load("configs", config)
    enc = dict(cfg["encoder"], input_size=item, region_size=region)
    limits = load("limits", workload)
    seed = 77
    pool = store.PlanePool(seed, 2, region, "cpu")
    slide = store.make_slides(pool, np.array([2]), (1, 2),
                              np.random.default_rng(seed))[0]
    coords = store.tissue_coords(slide, item)[:n]
    y, cb, cr = (torch.from_numpy(p) for p in
                 slide.read_regions_planes(coords, 0, (item, item)))
    with exact_f32():
        w = weights.encoder_weights(cfg, seed, "cpu")
        want = reference_features(enc, w, y, cb, cr, "f32")
        got = reference_features(enc, w, y, cb, cr,
                                 enc["control_precision"])
        numbers = {"feat_err": rel_rows(got, want)}
        numbers.update(head_numbers(cfg, want, seed))
    failed = [k for k in limits if numbers[k] > limits[k]]
    assert failed, (numbers, limits)
