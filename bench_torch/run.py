"""The benchmark of the PyTorch + CUDA port (`multimodal_flows_tpu_torch`).

    python3 bench_torch/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout.  It needs the CUDA card(s) the cell asks
for and never falls back to the CPU: without them it exits with code 2 and
prints no result.  The last line of standard output is the result (JSON);
the last lines of standard error are the numbers the correctness check
compared, each beside its limit.  Build and kernel caches stay inside the
checkout, under `build/`.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "bench_torch"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[var] = str(CACHE / sub)
    sys.path.insert(0, str(ROOT))

    import torch

    # one process with few threads: the window's host work is one thread's
    torch.set_num_threads(1)
    with open(ROOT / "BENCHMARK.json") as f:
        cells = {c["name"]: c for c in json.load(f)["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    chips = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2

    from bench_torch.harness import report, run_cell

    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), T_START)
    report(result, result.pop("notes"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
