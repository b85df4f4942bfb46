"""Time K1 and K2 at their packed-row shapes in one or more checkouts of
this repository, in turns, on one GPU.

    python3 kernel_times.py [TREE ...]

Each TREE (default: this checkout) is the root of a checkout with its own
`chip_smoke.py`; its kernels are built from its own sources into its own
`build/` and timed in a process of its own, in the order given, so
`python3 kernel_times.py parent . . parent` compares two versions on one
card and shows their spread.  What is timed is what `chip_smoke.py` times
(`time_kernels`, `time_bf16_kernels`, `time_gpt_attention`): K1 in its
segment form and K2 with a (B, H, T, T) bias + segments at B=128 T=128 H=4,
C=128 and 256, fp32 and bf16; K1's key-mask form on the wide jets
(8 x 150 x 256); GPT's full forward (K2's causal and bias forms) and its
decode at positions 151 and 75; then more fp32 forms (`FP32_FORMS`): K1
and K2 at the tensor-parallel shard shapes (H=2 of the flagship's 4 heads)
and the wide forms that lost to `scaled_dot_product_attention` before the
fp32 core moved to TMA and `wgmma` (head sizes 136-512 in slices, the
key-mask form at 512 and 2048 keys, causal at 1024, the decode at head
size 256), each as `chip_smoke.py:_wide_case` makes it, beside the library
call ("... sdpa"); and, in a tree that has it, the Lund pair MLP kernel
(`time_lund_pair_mlp`) at B=128 D=128 and B=8 D=150 beside its plain
version ("... plain").
Each tree prints one line `TIMES <tree> {json}` of device milliseconds; the
first line is the card's name and power limit.  Needs CUDA; exits non-zero
without it.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

# (B, Tq, Tk, C, H, form) as chip_smoke.py's WIDE_CASES
FP32_FORMS = [(128, 128, 128, 64, 2, "segments"), (128, 128, 128, 64, 2, "bias_segments"),
              (128, 128, 128, 128, 2, "segments"), (128, 128, 128, 128, 2, "bias_segments"),
              (8, 300, 300, 272, 2, "key_mask"), (8, 300, 300, 320, 2, "bias_segments"),
              (8, 300, 300, 256, 1, "key_mask"), (8, 300, 300, 256, 1, "bias"),
              (4, 300, 300, 512, 1, "key_mask"), (4, 300, 300, 512, 1, "bias"),
              (4, 512, 512, 256, 4, "key_mask"), (1, 2048, 2048, 256, 4, "key_mask"),
              (2, 1024, 1024, 256, 4, "causal"), (16, 1, 302, 512, 2, "decode")]


def _time_tree(tree: str) -> dict:
    """Build and time one checkout's kernels in this process."""
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch

    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    for mod in (cs.k1, cs.k2):
        mod.build()
    lund = getattr(cs, "lpm", None)
    if lund is not None:
        lund.build()
    dev = torch.device("cuda:0")
    times = {}
    for (name, shape), t in cs.time_kernels(dev).items():
        times[f"{name} fp32 {'x'.join(map(str, shape))}"] = t["ms"]
    for (name, shape), t in cs.time_bf16_kernels(dev).items():
        times[f"{name} bf16 {'x'.join(map(str, shape))}"] = t["ms"]
    for form, t in cs.time_gpt_attention(dev).items():
        times[f"K2 GPT {form}"] = t["ms"]
    with torch.no_grad():
        for case in FP32_FORMS:
            c = cs._wide_case(case, dev, seed=3)
            name = cs._wide_name(case)
            library = cs._library_call(c["q"], c["k"], c["v"], case[4], c["ref_btc"], c["rows"],
                                       name, **c["sdpa"])
            times[name], times[f"{name} sdpa"] = cs.median_device_ms([c["kernel"], library])
    if lund is not None:
        for shape, t in cs.time_lund_pair_mlp(dev).items():
            times[f"Lund pair MLP {shape}"], times[f"Lund pair MLP {shape} plain"] = (
                t["ms"], t["plain_ms"])
    return times


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        print(f"TIMES {argv[1]} {json.dumps(_time_tree(argv[1]))}", flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("kernel_times.py needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0], flush=True)
    rc = 0
    for tree in argv or ["."]:
        proc = subprocess.run([sys.executable, __file__, "--one", tree], capture_output=True,
                              text=True)
        lines = [line for line in proc.stdout.splitlines() if line.startswith("TIMES ")]
        print("\n".join(lines) or f"{tree}: failed\n{proc.stdout[-2000:]}{proc.stderr[-2000:]}",
              flush=True)
        rc = rc or proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
