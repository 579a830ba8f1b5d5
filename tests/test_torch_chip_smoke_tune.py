"""chip_smoke phase 14 (``phase_tune``: tuning, trial- and fold-parallel
training, sampling tuning through the pool, flax heads) rehearsed on the
CPU at small sizes, with ``read_counts`` counting the pool's calls: it
passes on the port as it is (the pool launched 8 x (iterations + 1) times
per sampling trial, on 3 slides here), and stops at its lane check when the
stacked Adam step takes its lanes' learning rates in the wrong order."""
import pytest
import torch

import chip_smoke


@pytest.mark.parametrize("fault", [None, "lanes_lr_reversed"])
def test_phase_tune_rehearsal(fault, monkeypatch):
    from hipt_abmil_atec23_tpu_torch.engine import tune_parallel as tp
    from hipt_abmil_atec23_tpu_torch.ops import gated_attention_pool as gap
    counts = {}
    real = gap.gated_attention_pool

    def counting(*a, **k):
        counts["gated_pool"] = counts.get("gated_pool", 0) + 1
        return real(*a, **k)

    monkeypatch.setattr(gap, "gated_attention_pool", counting)
    monkeypatch.setattr(chip_smoke, "zero_counts", counts.clear)
    monkeypatch.setattr(chip_smoke, "read_counts", lambda: {
        name: counts.get(name, 0) for name in chip_smoke.COUNTERS})
    if fault:
        update = tp.adam_l2_update
        monkeypatch.setattr(tp, "adam_l2_update", lambda p, g, m, v, c, lr,
                            reg: update(p, g, m, v, c, lr.flip(0), reg))
    records = {"gated_pool": {}}
    run = lambda: chip_smoke.phase_tune(
        torch.device("cpu"), "cpu", records, n_slides=30, bag_range=(40, 90),
        dras_bags=(3, (1700, 1900)), size_arg="hipt_smaller", d=192,
        lanes=4, epochs=(3, 2, 2, 3))
    if fault:
        with pytest.raises(SystemExit, match=r"tune \(b\)"):
            run()
        return
    res = run()
    tune = records["gated_pool"]["tune"]
    # (e) launches 3 x (iterations + 1) per trial, (f) the full-bag
    # evaluate_fold of 8 bags, _mil_bucketed and apply_pooled, per format
    assert tune["launches"] == tune["launches_sampling"] + 2 * (8 + 2)
    assert res["launches"]["gated_pool"] == tune["launches"]
