"""BENCHMARK.json against the benchmark's contract, and the data-driven
layout: every configuration, traffic, limits and metric file loads by
name, and a cell made only of new files is found without an edit."""
import ast
import json
import os
import re
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "port_bench")
sys.path.insert(0, ROOT)

from port_bench import harness  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def bench():
    return harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "port_bench/run.py"]
    assert bench["paths"] == ["port_bench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 << 10


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries(bench, section):
    names = [e["name"] for e in bench[section]]
    assert len(names) == len(set(names))
    for e in bench[section]:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") \
            else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        for k in ("why", "layer", "source"):
            if k in e and section in ("configs", "workloads", "per_layer"):
                assert line(e[k]), (e["name"], k)
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                             "higher")


def test_metrics_reach_their_cells(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert 0.01 <= min(m["bound"] for m in e2e.values())
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in \
        e2e["setup_s"]
    assert all(m["source"] in ("host_clock", "device_trace")
               for m in e2e.values())
    layers = {}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
        layers.setdefault(m["layer"], []).append(m["name"])
    for cell in cells:
        assert any(cell in m.get("workloads", [cell])
                   for m in bench["per_layer"])
        assert any(cell in m.get("workloads", [cell])
                   for n, m in e2e.items() if n != "setup_s")


def test_every_file_loads_by_name(bench):
    for w in bench["workloads"]:
        files = harness.cell_files(bench, ROOT, w["name"])
        assert files.traffic["driver"] and os.path.exists(os.path.join(
            BENCH, "drivers", files.traffic["driver"] + ".py"))
        assert set(files.limits) and all(v > 0
                                         for v in files.limits.values())
        assert files.config["name"] == w["config"]
        assert files.config["reduced"] == []
        for m in files.per_layer:
            mod = harness.load_module(harness.metric_path(m["name"]), "m")
            assert callable(mod.read)
    for c in bench["configs"]:
        assert c["file"].startswith("port_bench/configs/")
        assert harness.load_json(os.path.join(ROOT, c["file"]))["source"] \
            == c["source"]


def test_file_names_are_names():
    for dirpath, _, names in os.walk(BENCH):
        if "__pycache__" in dirpath:
            continue
        for n in names:
            rel = os.path.relpath(os.path.join(dirpath, n), ROOT)
            assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", rel), rel


def test_a_new_cell_needs_no_edit(tmp_path, bench):
    """Copy the benchmark, add a traffic mix, a metric and a limits file
    and one BENCHMARK.json entry: the harness finds every part by name."""
    shutil.copytree(BENCH, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    new = dict(bench)
    new["workloads"] = bench["workloads"] + [{
        "name": "hipt4k.serve.plane.few", "config":
        "hipt4k_clam_sb_hipt_smaller", "traffic": "serve.plane.few",
        "chips": 1, "why": "fewer regions per slide"}]
    new["end_to_end"] = [
        dict(m, workloads=m["workloads"] + ["hipt4k.serve.plane.few"])
        if m["name"] == "slide_mpx_per_s.hipt4k" else m
        for m in bench["end_to_end"]]
    new["per_layer"] = bench["per_layer"] + [{
        "name": "busy_share.few", "unit": "%", "better": "higher",
        "source": "device_trace", "layer": "device",
        "moves": "slide_mpx_per_s.hipt4k",
        "workloads": ["hipt4k.serve.plane.few"]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))
    traffic = harness.load_json(os.path.join(
        BENCH, "traffic", "serve.plane.regions.json"))
    traffic["regions_per_slide"] = [2, 4]
    (tmp_path / "port_bench" / "traffic" / "serve.plane.few.json") \
        .write_text(json.dumps(traffic))
    (tmp_path / "port_bench" / "limits" / "hipt4k.serve.plane.few.json") \
        .write_text(json.dumps({"feat_err": 1.0}))
    (tmp_path / "port_bench" / "metrics" / "busy_share.few.py").write_text(
        "def read(ctx):\n    return 1.0\n")
    sys.path.insert(0, str(tmp_path))
    try:
        sys.modules.pop("port_bench.harness", None)
        sys.modules.pop("port_bench", None)
        import port_bench.harness as fresh
        files = fresh.cell_files(fresh.load_json(str(tmp_path /
                                                     "BENCHMARK.json")),
                                 str(tmp_path), "hipt4k.serve.plane.few")
        assert files.traffic["regions_per_slide"] == [2, 4]
        assert [m["name"] for m in files.per_layer] == ["busy_share.few"]
        assert [m["name"] for m in files.end_to_end] == [
            "slide_mpx_per_s.hipt4k", "setup_s"]
        assert fresh.read_per_layer(files.per_layer, None) == {
            "busy_share.few": 1.0}
    finally:
        sys.path.remove(str(tmp_path))
        sys.modules.pop("port_bench.harness", None)
        sys.modules.pop("port_bench", None)


def test_metric_readers_return_nothing_without_their_work():
    """A reader that finds nothing to read returns None, never 0."""
    from types import SimpleNamespace
    from port_bench.trace import DeviceTrace
    empty = DeviceTrace([("other_kernel", 0, 10)], 0, 100)
    ctx = SimpleNamespace(trace=empty, counts={"read_px": 0,
                                               "batch_items": [2]},
                          config=harness.load_json(os.path.join(
                              BENCH, "configs",
                              "hipt4k_clam_sb_hipt_smaller.json")),
                          window_s=1e-7)
    for name in ("fused_block_roofline", "read_ms_per_mpx.hipt4k",
                 "read_ms_per_mpx.resnet50"):
        mod = harness.load_module(harness.metric_path(name), "m")
        assert mod.read(ctx) is None, name


def test_a_metric_reads_its_own_file_else_its_base():
    """``<base>.<part>`` is read by ``metrics/<base>.<part>.py`` where that
    exists, else by ``metrics/<base>.py``; one file serves every cell."""
    metrics = os.path.join(BENCH, "metrics")
    assert harness.metric_path("device_idle.hipt4k") == os.path.join(
        metrics, "device_idle.py")
    assert harness.metric_path("mfu.a.b") == os.path.join(metrics,
                                                          "mfu.py")
    assert harness.metric_path("fused_block_roofline") == os.path.join(
        metrics, "fused_block_roofline.py")
    own = sorted(n[:-3] for n in os.listdir(metrics) if n.endswith(".py"))
    for name in own:
        assert harness.metric_path(name) == os.path.join(metrics,
                                                         name + ".py")


def test_mfu_counts_the_configured_encoder():
    """mfu.py takes each configuration's own item: a HIPT_4K region or a
    ResNet50-trunc patch, padding left out, and the head per slide."""
    from types import SimpleNamespace
    from port_bench import counts
    mod = harness.load_module(harness.metric_path("mfu.resnet50"), "m")
    for cfg_name, item in (("hipt4k_clam_sb_hipt_smaller",
                            counts.hipt_region_flops),
                           ("resnet50trunc_clam_sb_small",
                            counts.resnet_patch_flops)):
        cfg = harness.load_json(os.path.join(BENCH, "configs",
                                             cfg_name + ".json"))
        head = cfg["head"]
        ctx = SimpleNamespace(config=cfg, window_s=2.0, counts={
            "items_dispatched": 10, "slide_items": [4, 6]})
        want = (10 * item(cfg["encoder"])
                + counts.clam_flops(head["size"], head["n_classes"], 4)
                + counts.clam_flops(head["size"], head["n_classes"], 6))
        assert mod.read(ctx) == pytest.approx(
            100 * want / (2.0 * counts.BF16_FLOP_S), rel=1e-12)


def test_metric_files_parse():
    for n in os.listdir(os.path.join(BENCH, "metrics")):
        if n.endswith(".py"):
            tree = ast.parse(open(os.path.join(BENCH, "metrics", n)).read())
            assert any(isinstance(f, ast.FunctionDef) and f.name == "read"
                       for f in tree.body), n


def test_fused_block_roofline_counts_real_regions():
    """The least time counts each batch at its real size: a tail batch of
    one region of a batch-2 encoder is not a batch of two."""
    from types import SimpleNamespace
    from port_bench import counts
    from port_bench.trace import DeviceTrace
    cfg = harness.load_json(os.path.join(
        BENCH, "configs", "hipt4k_clam_sb_hipt_smaller.json"))
    enc = cfg["encoder"]
    trace = DeviceTrace([("void gemm_kernel<2>(x)", 0, 10 ** 9),
                         ("other_kernel", 0, 10 ** 9)], 0, 2 * 10 ** 9)
    ctx = SimpleNamespace(trace=trace, config=cfg,
                          counts={"batch_items": [2, 2, 1, 2, 1]})
    mod = harness.load_module(harness.metric_path("fused_block_roofline"),
                              "m")
    want = (3 * counts.hipt_blocks_least_seconds(enc, 2)
            + 2 * counts.hipt_blocks_least_seconds(enc, 1))
    assert mod.read(ctx) == pytest.approx(100 * want / 1.0, rel=1e-12)
    assert counts.hipt_blocks_least_seconds(enc, 1) < \
        counts.hipt_blocks_least_seconds(enc, 2)
