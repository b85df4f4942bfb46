"""Each fault of `test_checks.py`, planted in the program underneath the
timed path, at the cell's own size on the card: the numbers the check
compares, one line a seed (`FAULT <cell> <fault> <seed> {numbers}`).

    python3 bench_torch/tests/faults.py --workload <cell> --seconds 5 --seeds 21 22 23
"""

import argparse
import json
import sys
import time
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import test_checks  # noqa: E402
from bench_torch.harness import run_cell  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("the faults are read on the card", file=sys.stderr)
        return 2
    for cell, fault in test_checks.FAULTS:
        if cell != args.workload:
            continue
        for seed in args.seeds:
            with pytest.MonkeyPatch.context() as mp:
                fault(mp, cell)
                res = run_cell(cell, seed, args.seconds, False, torch.device("cuda", 0),
                               time.perf_counter())
            print("FAULT", cell, fault.__name__[1:], seed,
                  json.dumps({k: v["value"] for k, v in res["checks"].items()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
