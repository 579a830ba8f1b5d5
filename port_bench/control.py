"""The controls that show the comparison deciding ``correct`` can fail.

    python3 port_bench/control.py --workload <name> --seeds 1 2 3 \
        [--seconds 8]

For each seed, in one process: the cell's set-up and a short window at
its own load, then the compared numbers twice over the same sample: the
program's, and the control's, where the plain reference in the precision
below the configuration's stands in the program's place (the encoder's
bf16 as fp8 e4m3, the head's f32 as TF32; reference/precision.py). One
JSON line per seed. The benchmark's own runs never run this; it needs a
card, as run.py does.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def control_numbers(files, seed: int, seconds: float, device) -> dict:
    """{"program": numbers, "control": numbers, "limits": limits} for one
    seed of the cell that ``files`` describes."""
    import torch
    from port_bench import harness
    driver = harness.make_driver(files, seed, device)
    driver.setup(seconds)
    driver.window(seconds)
    driver.free()
    out = {"program": driver.check(), "control": driver.check("control"),
           "limits": files.limits}
    del driver
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    args = ap.parse_args(argv)
    import torch
    from port_bench import harness
    if not torch.cuda.is_available():
        print("the controls run on a CUDA card", file=sys.stderr)
        return 3
    files = harness.cell_files(
        harness.load_json(os.path.join(ROOT, "BENCHMARK.json")), ROOT,
        args.workload)
    for seed in args.seeds:
        res = control_numbers(files, seed % (1 << 63), args.seconds,
                              torch.device("cuda", 0))
        print(json.dumps({"workload": args.workload, "seed": seed, **res}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
