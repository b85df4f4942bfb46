"""Profiling helpers (PyTorch port of `multimodal_flows_tpu/utils/profiling.py`,
with the card's timers that `chip_smoke.py` uses).

- `trace(logdir)`: a `torch.profiler` trace of the block, written as a
  Chrome trace into `logdir` (a no-op for None);
- `force_completion(tree)`: waits for the device and returns the sum of
  every float tensor of a nested structure, a host number;
- `device_timer(fn, *args)`: the median wall time of `fn(*args)`, each call
  forced to completion (seconds, any device);
- `median_device_ms(fns)`: the median CUDA-event device time of each fn,
  run in turns with the stream held while the host enqueues, so the time is
  the kernels' own and not the host's launch overhead;
- `step_phases` and `profile_steps`: train steps under `torch.profiler`,
  their device time split into forward, backward and optimizer, the busy
  share's numerator, the launches and the kernels by name.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Callable, Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

# GPU clock cycles (about 1 ms) that a sleep kernel holds the stream before
# each timed call, so the host has enqueued the call's kernels when the
# start event runs
HOLD_CYCLES = 2_000_000


@contextlib.contextmanager
def trace(logdir: Optional[str]) -> Iterator[None]:
    """Profile the block (CPU, and CUDA when there is a card) and write a
    Chrome trace `trace_<ns>.json` into `logdir` (no-op when None)."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{time.time_ns()}.json"))


def _tensors(tree) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, Mapping):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))


def force_completion(tree) -> float:
    """Wait for every device the tensors of `tree` live on and return the
    sum of its float tensors as a host float (0.0 without any)."""
    leaves = list(_tensors(tree))
    if any(t.is_cuda for t in leaves):
        torch.cuda.synchronize()
    return float(sum(float(t.sum()) for t in leaves if t.is_floating_point()))


def device_timer(fn: Callable, *args, iters: int = 3, warmup: int = 1) -> float:
    """Median wall seconds of `fn(*args)` (the upper one of an even count),
    each call forced to completion."""
    for _ in range(warmup):
        force_completion(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        force_completion(fn(*args))
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2]


def median_device_ms(fns: Sequence[Callable], n: int = 40, warmup: int = 5) -> List[float]:
    """Median CUDA-event device time (ms) of each fn, the fns run in turns.
    The stream is held while the host enqueues fn, so the time is the
    kernels' own and not the host's launch overhead; a fn that launches
    more kernels than the stream's queue holds is timed with part of its
    host time."""
    for fn in fns:
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for _ in range(n):
        for fn, ts in zip(fns, times):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(HOLD_CYCLES)
            start.record()
            fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end))
    return [float(np.median(ts)) for ts in times]


def step_phases(trainer, state, batch, gen) -> None:
    """One train step of `trainer` with its phases named for the profiler:
    `train_forward` (the loss) and `train_optimizer` (the update); the
    backward between them is launched by autograd's own thread."""
    from torch.profiler import record_function

    from multimodal_flows_tpu_torch.parallel.mesh import data_rows

    with record_function("train_forward"):
        loss, _ = trainer.system.loss_fn(batch, gen, train=True, module=state.module,
                                         rows=data_rows(len(batch), trainer.mesh))
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    with record_function("train_optimizer"):
        trainer._update(state)


@dataclasses.dataclass
class StepProfile:
    """Per step, over the profiled steps: the host wall (ms), the device
    time (ms) in total and by phase, `cudaLaunchKernel` calls, and the
    kernels as (name, device ms, launches), longest first."""

    steps: int
    wall_ms: float
    device_ms: float
    phases: Dict[str, float]
    launches: float
    kernels: List[Tuple[str, float, float]]
    events: list = dataclasses.field(repr=False, default_factory=list)

    def kernel_ms(self, substring: str) -> float:
        """Device ms a step of the kernels whose name holds `substring`."""
        return sum(ms for name, ms, _ in self.kernels if substring in name)

    def nodes(self, name: str) -> Tuple[float, float]:
        """(count, device ms) a step of the outermost CPU events whose name
        holds `name`, e.g. an autograd node `SetAttentionBackward`."""
        found = [e for e in self.events if e.device_type.name == "CPU" and name in e.name
                 and not (e.cpu_parent is not None and name in e.cpu_parent.name)]
        return (len(found) / self.steps,
                sum(e.device_time_total for e in found) / self.steps / 1e3)


def profile_steps(step: Callable[[int], None], n: int) -> StepProfile:
    """Run `step(i)` for i < n under `torch.profiler` (CPU and CUDA), ending
    in a synchronize.  The device time of the `train_forward` and
    `train_optimizer` ranges (`step_phases`) is the forward and the
    optimizer; the rest of the top-level events' device time is the
    backward."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            step(i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    events = prof.events()
    phases = {name: sum(e.device_time_total for e in events
                        if e.name == f"train_{name}" and e.device_type.name == "CPU") / n / 1e3
              for name in ("forward", "optimizer")}
    total_ms = sum(e.device_time_total for e in events
                   if e.device_type.name == "CPU" and e.cpu_parent is None) / n / 1e3
    phases["backward"] = total_ms - phases["forward"] - phases["optimizer"]
    averages = prof.key_averages()
    launches = sum(e.count for e in averages if e.key == "cudaLaunchKernel") / n
    annotations = {e.key for e in averages if e.device_type.name == "CPU"}
    kernels = sorted(((e.key, e.self_device_time_total / n / 1e3, e.count / n) for e in averages
                      if e.device_type.name == "CUDA" and e.key not in annotations),
                     key=lambda k: k[1], reverse=True)
    return StepProfile(n, wall_ms, total_ms, phases, launches, kernels, list(events))
