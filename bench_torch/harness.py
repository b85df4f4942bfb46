"""One run of one cell: what `run.py` calls once it has found the card(s).

Everything that belongs to one cell is found by name:
- the cell in `BENCHMARK.json` names a configuration and a traffic mix;
- the configuration's `file` (`configs/<name>.json`) holds the program's
  `Config` fields, its `architecture` (the module of `reference/` that is
  its plain reference, its weights from the seed and its counts of work)
  and the `system` the program builds;
- the traffic mix (`traffic/<name>.json`) holds the parameters that the
  general jet generator (`jets.py`) and one entry driver read; `driver`
  names the module of `drivers/`;
- `limits/<cell>.json` holds the limit of each number the correctness check
  compares;
- each per-layer metric is `metrics/<name>.py`, a reader of the trace.

A run: weights from the seed on the device, the driver's set-up (the
system, the inputs, the warm-up: all of it `setup_s`), the window, the peak
memory, the end-to-end metrics (or, traced, the per-layer ones), then the
program's state freed and the check against the reference.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from bench_torch import counts, jets
from bench_torch.trace import traced

PATHS = Path(__file__).resolve().parent
ROOT = PATHS.parent


class Run:
    """The inputs of one run, handed to the driver."""

    def __init__(self, cell: Dict, cfg: Dict, traffic: Dict, seed: int, device: torch.device,
                 trace: bool):
        self.cell, self.cfg, self.traffic = cell, cfg, traffic
        self.seed, self.device, self.trace = seed, device, trace
        self.reference = counts.architecture(cfg)
        self.params = self.reference.draw_weights(cfg, jets.sub_seed(seed, 1), device)

    def config(self, **overrides):
        """The program's `Config` of the configuration file."""
        from multimodal_flows_tpu_torch.config import Config

        fields = set(Config.__dataclass_fields__)
        return Config(**{k: v for k, v in {**self.cfg, **overrides}.items() if k in fields})


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def find(items: List[Dict], name: str, what: str) -> Dict:
    for item in items:
        if item["name"] == name:
            return item
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def cell_metrics(bench: Dict, cell: str, kind: str) -> List[Dict]:
    """The `end_to_end` or `per_layer` metrics that `cell` reports: an
    end-to-end metric without `workloads` is every cell's; a per-layer
    metric names its cells."""
    if kind == "end_to_end":
        return [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    for m in bench["per_layer"]:
        if "workloads" not in m:
            raise SystemExit(f"per-layer metric {m['name']!r} lists no workloads")
    return [m for m in bench["per_layer"] if cell in m["workloads"]]


def read_metric(name: str, ctx) -> Optional[float]:
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}",
                                                  PATHS / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(ctx)


class Context:
    """What a per-layer metric reads, from the three windows of a traced
    run (`drivers/common.py:work_record` for the work):
    - `trace`, `work`, `steps`: the window traced on the device alone
      (CUPTI's kernel, copy and fill records and the runtime calls), which
      adds little to the host's time;
    - `detail`, `detail_steps`: the window traced with the host's ops and
      ranges too, which labels the idle gaps and splits a train step into
      its phases, and slows a host-bound loop;
    - `plain_work`, `plain_wall`: an untraced window, for the rates."""

    def __init__(self, cfg: Dict, **windows):
        self.cfg = cfg
        self.__dict__.update(windows)


def traced_windows(driver, seconds: float, cfg: Dict) -> Context:
    """The three windows of a traced run, each of `seconds`."""
    t0 = time.perf_counter()
    driver.window(seconds)
    plain = dict(plain_wall=time.perf_counter() - t0, plain_work=driver.traced_work())
    detail = traced(lambda: driver.window(seconds), host=True)
    detail_steps = driver.traced_steps()
    trace = traced(lambda: driver.window(seconds), host=False)
    return Context(cfg, trace=trace, work=driver.traced_work(), steps=driver.traced_steps(),
                   detail=detail, detail_steps=detail_steps, **plain)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: torch.device,
             t_start: float, cfg_override: Optional[Dict] = None,
             traffic_override: Optional[Dict] = None, control: bool = False) -> Dict:
    """One run; with `control`, the check's control too, on the same
    window (`control_checks`, `control_correct`)."""
    t_enter = time.perf_counter()
    bench = load_json(ROOT / "BENCHMARK.json")
    cell = find(bench["workloads"], workload, "workload")
    cfg = {**load_json(ROOT / find(bench["configs"], cell["config"], "config")["file"]),
           **(cfg_override or {})}
    traffic = {**load_json(PATHS / "traffic" / f"{cell['traffic']}.json"),
               **(traffic_override or {})}
    limits = load_json(PATHS / "limits" / f"{workload}.json")

    # the configurations state fp32 with TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = Run(cell, cfg, traffic, seed, device, trace)
    t_weights = time.perf_counter()
    driver = importlib.import_module(f"bench_torch.drivers.{traffic['driver']}").Driver(run)
    driver.setup()
    setup_s = time.perf_counter() - t_start
    # where the set-up went: interpreter and imports, weights (with the
    # card's context), the driver's system, inputs and warm-up
    setup_parts = {"setup_imports_s": t_enter - t_start, "setup_weights_s": t_weights - t_enter,
                   "setup_driver_s": t_start + setup_s - t_weights}

    if trace:
        ctx = traced_windows(driver, min(seconds, traffic["trace_seconds"]), cfg)
    else:
        driver.window(seconds)
    on_cuda = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if on_cuda else 0

    result = {"correct": False, "attempted": driver.attempted, "failed": driver.failed}
    if trace:
        values = {m["name"]: (read_metric(m["name"], ctx), m["unit"])
                  for m in cell_metrics(bench, workload, "per_layer")}
    else:
        e2e = driver.metrics()
        e2e["setup_s"] = setup_s
        values = {m["name"]: (e2e.get(m["name"]), m["unit"])
                  for m in cell_metrics(bench, workload, "end_to_end")}
    result["metrics"] = {k: {"value": v, "unit": u} for k, (v, u) in values.items()
                         if v is not None}
    result["device"] = {
        "platform": "gpu" if on_cuda else device.type,
        "kind": torch.cuda.get_device_name(device) if on_cuda else device.type,
        "count": int(cell["chips"]),
        "memory_peak_bytes": int(peak)}
    if trace:
        result["device"].update(busy_s=ctx.trace.busy_s(), window_s=ctx.trace.window_s)
        result["breakdown"] = {"device_ops": ctx.trace.top_ops(),
                               "idle_gaps": ctx.detail.idle_by_host()}

    driver.release()
    if on_cuda:
        torch.cuda.empty_cache()

    def judged(checks):
        ok = all(math.isfinite(v) and v <= limits[name] for name, v in checks.items())
        return (bool(ok and driver.failed == 0 and set(checks) == set(limits)),
                {name: {"value": v, "limit": limits.get(name)} for name, v in checks.items()})

    if control:
        result["control_correct"], result["control_checks"] = judged(driver.check(True))
    result["correct"], result["checks"] = judged(driver.check(False))
    result["notes"] = {**setup_parts, **getattr(driver, "notes", {})}
    return result


def report(result: Dict, notes: Optional[Dict] = None) -> None:
    """The compared numbers beside their limits as the last lines of
    standard error (after the check's other readings, `notes`), then the
    result as the last line of standard output."""
    for name, v in (notes or {}).items():
        print(f"note {name} = {v!r}", file=sys.stderr)
    print(f"correct = {result['correct']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
