"""The control of each cell's correctness check, on the card, at the
cell's own size: for each seed, one run of the cell's window (`--seconds`)
and its check as it stands, and on the same window the check with the
reference at TF32 put in the program's place
(`reference/common.py:Ops(lowp=True)`).  The control has to read as not
correct.

    python3 bench_torch/tests/control.py --workload <cell> --seconds 5 --seeds 11 12 13

One line a seed: `SOUND <cell> <seed> {numbers}` and `CONTROL ...`.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    from bench_torch.harness import run_cell

    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        res = run_cell(args.workload, seed, args.seconds, False, torch.device("cuda", 0),
                       time.perf_counter(), control=True)
        for tag, key in (("SOUND", "checks"), ("CONTROL", "control_checks")):
            print(tag, args.workload, seed, json.dumps({k: v["value"] for k, v in
                                                         res[key].items()}),
                  json.dumps(res["notes"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
