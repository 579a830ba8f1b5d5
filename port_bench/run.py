"""The benchmark of the PyTorch and CUDA port, one cell once:

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds BENCHMARK.json and the port
(``hipt_abmil_atec23_tpu_torch``). It needs as many CUDA cards as the cell
asks for and exits non-zero, printing no result, without them. The last
line of standard output is the result as one JSON object; the numbers
compared to decide ``correct`` are the last lines of standard error and the
result's last key, ``checks``.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".bench_cache")
# every compiler cache at a fixed place inside the checkout, so only a
# cell's first run there builds (the port's nvcc builds already live in
# hipt_abmil_atec23_tpu_torch/kernels/_build)
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["PYTORCH_KERNEL_CACHE_PATH"] = os.path.join(CACHE, "torch_kernels")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from port_bench import harness

    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    files = harness.cell_files(bench, ROOT, args.workload)
    chips = int(files.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    # one process with few threads: the store's reads and the stream's
    # worker beside the main loop
    torch.set_num_threads(4)
    # the seed may pass 32 bits; every generator takes it modulo 2**63
    seed = args.seed % (1 << 63)
    result = harness.run_cell(files, seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0), T_START, chips)
    found = harness.forbidden_modules()
    if found:
        print("loaded in the measured process: " + ", ".join(found),
              file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
