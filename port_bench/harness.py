"""One run of one cell: set-up, the measured window, the comparison that
decides ``correct``, and the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric lives in files of its own that this module finds by name:
``configs/<config>.json`` (through BENCHMARK.json), ``traffic/<traffic>.json``
(which names its driver, ``drivers/<driver>.py``), ``metrics/<metric>.py``
(a ``read(ctx)`` that returns a number, or None where it finds nothing to
read; a metric ``<base>.<part>`` without a file of its own is read by
``metrics/<base>.py``) and ``limits/<workload>.json`` (each compared
number's limit).
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
import time
from types import SimpleNamespace
from typing import Dict, List

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "hipt_abmil_atec23_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_files(bench: dict, root: str, workload: str) -> SimpleNamespace:
    """The cell's entry, configuration, traffic, limits and metric
    entries, from BENCHMARK.json ``bench`` and the files it names."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]

    def reports(m):
        return "workloads" not in m or workload in m["workloads"]

    return SimpleNamespace(
        cell=cell,
        config=load_json(os.path.join(root, cfg_entry["file"])),
        traffic=load_json(os.path.join(HERE, "traffic",
                                       f"{cell['traffic']}.json")),
        limits=load_json(os.path.join(HERE, "limits", f"{workload}.json")),
        end_to_end=[m for m in bench["end_to_end"] if reports(m)],
        per_layer=[m for m in bench["per_layer"] if reports(m)])


def make_driver(files: SimpleNamespace, seed: int, device):
    mod = importlib.import_module(
        f"port_bench.drivers.{files.traffic['driver']}")
    return mod.Driver(files.config, files.traffic, seed, device)


def metric_path(name: str) -> str:
    """The reader of metric ``name``: ``metrics/<name>.py``, else the file
    of its base name, the part before the first dot."""
    own = os.path.join(HERE, "metrics", f"{name}.py")
    if os.path.exists(own):
        return own
    return os.path.join(HERE, "metrics", f"{name.split('.')[0]}.py")


def read_per_layer(metrics: List[dict], ctx) -> Dict[str, float]:
    out = {}
    for m in metrics:
        mod = load_module(metric_path(m["name"]),
                          "port_bench_metric_" + m["name"].replace(".", "_"))
        value = mod.read(ctx)
        if value is not None:
            out[m["name"]] = float(value)
    return out


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or
    the JAX package's, compared whole (the port's name begins with the
    JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {value, limit}}): every compared number finite and
    within its limit; a number without a limit, or a limit without a
    number, is not correct."""
    checks = {k: {"value": float(v), "limit": float(limits.get(k, np.nan))}
              for k, v in numbers.items()}
    ok = (set(numbers) == set(limits)
          and all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values()))
    return ok, checks


def run_cell(files: SimpleNamespace, seed: int, seconds: float,
             trace: bool, device, t_start: float,
             chips: int = 1) -> dict:
    """Set up, measure, compare; returns the result line as a dict (the
    caller prints it). ``device`` a CPU runs everything but the device's
    readings (the benchmark's own tests)."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    driver = make_driver(files, seed, device)
    driver.setup(seconds)
    if cuda:
        torch.cuda.synchronize(device)
        # the peak of the window: the program's resident state and what the
        # window allocates, not the set-up's scratch
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start

    prof = None
    if trace:
        from port_bench.trace import start_profiler
        prof = start_profiler()
    win = driver.window(seconds)
    if cuda:
        torch.cuda.synchronize(device)
    t_close = time.time_ns()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    dev_trace = None
    if prof is not None:
        from port_bench.trace import DeviceTrace, device_events
        prof.__exit__(None, None, None)
        dev_trace = DeviceTrace(device_events(prof), win["t0_ns"], t_close)
        del prof
    driver.free()
    numbers = driver.check()
    correct, checks = judge(numbers, files.limits)

    units = {m["name"]: m["unit"]
             for m in files.end_to_end + files.per_layer}
    if trace:
        ctx = SimpleNamespace(trace=dev_trace, config=files.config,
                              traffic=files.traffic, counts=win["counts"],
                              window_s=dev_trace.window_s)
        values = read_per_layer(files.per_layer, ctx)
    else:
        values = {}
        for m in files.end_to_end:
            base = "setup_s" if m["name"] == "setup_s" \
                else m["name"].split(".")[0]
            values[m["name"]] = (setup_s if base == "setup_s"
                                 else win["end_to_end"][base])
    result = {
        "correct": bool(correct),
        "attempted": int(win["attempted"]),
        "failed": int(win["failed"]),
        "metrics": {k: {"value": v, "unit": units[k]}
                    for k, v in values.items()},
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
            "count": chips,
            "memory_peak_bytes": int(peak)},
    }
    if dev_trace is not None:
        result["device"]["busy_s"] = dev_trace.busy_s
        result["device"]["window_s"] = dev_trace.window_s
        result["breakdown"] = {
            "device_ops": dev_trace.top_ops(),
            "idle_gaps": dev_trace.idle_by_host(win["spans"])}
    if "host" in win:
        result["host"] = win["host"]
    result["checks"] = checks
    return result
