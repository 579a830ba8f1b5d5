"""The rest of a run, without the look for a card, on the CPU at narrow
widths: a sound program comes out correct, and with the timed path broken
underneath it comes out not correct, once per fault the cells can have:
half of a batch or of a bag left out and the mean taken over the rest,
and an answer altered where it is produced. The cells run on one card and no
step carries state, so the faults of an exchange between cards and of a
step returning its state unchanged do not arise."""
import copy
import os
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from port_bench import harness  # noqa: E402
from port_bench.drivers import serve_stream  # noqa: E402

import hipt_abmil_atec23_tpu_torch.engine.encode as encode  # noqa: E402
import hipt_abmil_atec23_tpu_torch.ops.gated_attention_pool as pool  # noqa


def narrow(workload):
    """The cell's files at widths and sizes a CPU test run can hold; the
    limits are the cell's own."""
    files = harness.cell_files(harness.load_json(
        os.path.join(ROOT, "BENCHMARK.json")), ROOT, workload)
    files = copy.deepcopy(files)
    c, t = files.config, files.traffic
    e = c["encoder"]
    if e["kind"] == "hipt4k":
        e.update(input_size=512, region_size=512)
        e["vit256"].update(embed_dim=48, depth=2, num_heads=3)
        e["vit4k"].update(input_embed_dim=48, depth=1, num_heads=6)
        t.update(region_size=512, regions_per_slide=[2, 5])
    else:
        e.update(input_size=64, patch_size=64, layers=[1, 1, 1],
                 batch_size=8)
        t.update(region_size=256, regions_per_slide=[1, 3], check_block=12)
    # every finished row and slide compared, so a fault cannot hide
    # outside the sample of a short window
    t.update(pool_regions=4, warm_slides=[1, 2], check_items=10 ** 6,
             check_slides=10 ** 6)
    return files


@pytest.fixture(autouse=True)
def cpu_job_list(monkeypatch):
    """A job list sized for the CPU's rate, not the card's."""
    monkeypatch.setattr(serve_stream, "MAX_MPX_PER_S", 40.0)


def run(workload, seed=20260):
    torch.manual_seed(0)
    return harness.run_cell(narrow(workload), seed, 1.0, False, "cpu",
                            time.perf_counter())


def half_batch(rows):
    """Rows past the first half replaced by the mean of the first half."""
    k = max(1, rows.shape[0] // 2)
    out = rows.clone()
    out[k:] = rows[:k].mean(0)
    return out


SERVE = ["hipt4k.serve.plane", "resnet50.serve.plane"]


@pytest.mark.parametrize("workload", SERVE)
def test_sound_program_is_correct(workload):
    res = run(workload)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert set(res["host"]) == {"read_ms_per_mpx", "stream_s", "score_s"}
    assert all(v > 0 for v in res["host"].values())


@pytest.mark.parametrize("workload", SERVE)
def test_half_batch_left_out(workload, monkeypatch):
    orig = encode.Encoder.apply_yuv
    monkeypatch.setattr(encode.Encoder, "apply_yuv",
                        lambda self, *a: half_batch(orig(self, *a)))
    res = run(workload)
    assert not res["correct"]
    assert res["checks"]["feat_err"]["value"] > \
        res["checks"]["feat_err"]["limit"]


@pytest.mark.parametrize("workload", SERVE)
@pytest.mark.parametrize("row,per_slot", [(0, None), (-1, 1)],
                         ids=["every_row_compared", "one_row_per_slot"])
def test_feature_altered_where_produced(workload, row, per_slot,
                                        monkeypatch):
    """One row of every batch altered fails the run; with one compared row
    per batch slot, the least sample the cells draw, as well."""
    orig = encode.Encoder.apply_yuv

    def altered(self, *a):
        out = orig(self, *a).clone()
        out[row] = out[row].flip(0)
        return out

    monkeypatch.setattr(encode.Encoder, "apply_yuv", altered)
    files = narrow(workload)
    if per_slot:
        files.traffic.update(
            check_items=per_slot * files.config["encoder"]["batch_size"],
            check_slides=1)
    torch.manual_seed(0)
    res = harness.run_cell(files, 20260, 1.0, False, "cpu",
                           time.perf_counter())
    assert not res["correct"], res["checks"]


def pooled_over_half(model, bag, mask):
    n = int(mask.sum())
    keep = torch.zeros(bag.shape[0], dtype=torch.bool)
    keep[:max(1, n // 2)] = True
    return ORIG_APPLY(model, bag, keep)


def answer_flipped(model, bag, mask=None):
    out = ORIG_APPLY(model, bag, mask)
    return out._replace(logits=-out.logits, y_prob=out.y_prob.flip(-1))


ORIG_APPLY = pool.apply_pooled


@pytest.mark.parametrize("workload", SERVE)
@pytest.mark.parametrize("fault", [pooled_over_half, answer_flipped],
                         ids=["half_bag", "answer_altered"])
def test_head_faults(workload, fault, monkeypatch):
    monkeypatch.setattr(pool, "apply_pooled", fault)
    res = run(workload)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("bs,per", [(2, 16), (256, 4), (8, 1)])
def test_sample_holds_every_slot_and_a_padded_tail(bs, per):
    """The rows compared hold ``per`` items of each slot of the encoder's
    batch and an item of a tail-padded batch where one finished."""
    import numpy as np
    d = serve_stream.Driver.__new__(serve_stream.Driver)
    d.seed, d.enc = 5100000013, {"batch_size": bs}
    d.traffic = {"check_items": bs * per, "check_slides": 3}
    sizes = [bs * 9, bs * 3 + 1, bs * 20, bs * 5]
    d.done = [(f"s{i}", np.zeros((n, 1))) for i, n in enumerate(sizes)]
    rows, slides = d.outputs_to_check()
    slots = np.bincount([j % bs for _, j in rows], minlength=bs)
    assert slots.min() >= per and len(rows) <= bs * per + 1
    assert any(i == 1 and j >= bs * 3 for i, j in rows)
    assert slides[0] == 2 and len(set(slides)) == 3
    assert rows == sorted(set(rows))
