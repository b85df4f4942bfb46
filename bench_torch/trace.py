"""The traced window (`--trace 1`) and its reduction.

`traced(fn, host)` runs `fn` under `torch.profiler` (the CUDA activity,
and with `host` the CPU's too) inside a `bench.window` range and keeps,
from the raw Kineto events:
- the device intervals (kernels, copies and fills) of the window, and its
  wall on the host's clock;
- the main thread's CPU events (ops, runtime calls, ranges), which label
  what the host was doing in each idle gap;
- the ranges `bench.train_forward` and `bench.train_optimizer` that the
  training drivers open, with the device time of the kernels whose launch
  lies inside them (the method of the program's `profiling.step_phases`:
  the backward, launched from autograd's thread, is the rest).
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import torch

WINDOW = "bench.window"
PHASES = ("bench.train_forward", "bench.train_optimizer")
RANGES = (WINDOW,) + PHASES
#: the hand-written kernels of the program's `csrc/` (K1 and K2 share them)
CSRC_KERNELS = ("attention_kernel_tf32", "attention_kernel_bf16", "merge_splits")


class Trace:
    """What the metric readers read of one traced window: every device
    record of the window, the window's wall on the host's clock, and (for
    a trace with the host's ops) the main thread's host events."""

    def __init__(self, events, window_s: float):
        cpu, dev = [], []
        main = None
        for e in events:
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                # the ranges reappear on the device's timeline as annotations
                if not (e.is_user_annotation() or e.name() in RANGES):
                    dev.append((e.start_ns(), e.end_ns(), e.name(), e.correlation_id()))
            else:
                cpu.append(e)
                if e.name() == WINDOW:
                    main = e.start_thread_id()
        self.window_s = window_s
        self.device = sorted(dev)
        self.host = sorted((e.start_ns(), e.end_ns(), e.name()) for e in cpu
                           if e.start_thread_id() == main and e.name() != WINDOW)
        self._phase_ms = self._phases(cpu, main)

    # ------------------------------------------------------------------ device

    def busy_s(self) -> float:
        """Seconds of the window in which some device operation ran."""
        busy, end = 0, None
        for s, e, _, _ in self.device:
            if end is None or s > end:
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        return busy / 1e9

    def kernels(self, substrings: Tuple[str, ...] = ()) -> List[Tuple[int, int, str, int]]:
        """The device operations (all, or those whose name holds one of
        `substrings`)."""
        if not substrings:
            return self.device
        return [d for d in self.device if any(s in d[2] for s in substrings)]

    def device_s(self, substrings: Tuple[str, ...] = ()) -> float:
        return sum(e - s for s, e, _, _ in self.kernels(substrings)) / 1e9

    def top_ops(self, n: int = 10) -> List[List]:
        by = defaultdict(int)
        for s, e, name, _ in self.device:
            by[name] += e - s
        return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    # ----------------------------------------------------------- idle and host

    def gaps(self) -> List[Tuple[int, int]]:
        out, end = [], None
        for s, e, _, _ in self.device:
            if end is not None and s > end:
                out.append((end, s))
            end = e if end is None else max(end, e)
        return out

    def idle_by_host(self, n: int = 10) -> List[List]:
        """Idle device seconds by the innermost host event running at each
        gap's midpoint ("host: between ops" where none runs)."""
        mids = sorted(((a + b) // 2, b - a) for a, b in self.gaps())
        by = defaultdict(int)
        stack: List[Tuple[int, str]] = []
        i = 0
        for mid, length in mids:
            while i < len(self.host) and self.host[i][0] <= mid:
                s, e, name = self.host[i]
                while stack and stack[-1][0] <= s:
                    stack.pop()
                stack.append((e, name))
                i += 1
            while stack and stack[-1][0] < mid:
                stack.pop()
            by[stack[-1][1] if stack else "host: between ops"] += length
        return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    # ------------------------------------------------------------------ phases

    def _phases(self, cpu, main) -> Dict[str, float]:
        ranges = {p: sorted((e.start_ns(), e.end_ns()) for e in cpu
                            if e.name() == p and e.start_thread_id() == main) for p in PHASES}
        if not any(ranges.values()):
            return {}
        launch_at = {e.correlation_id(): e.start_ns() for e in cpu
                     if e.correlation_id() and e.name().startswith(("cuda", "cu"))}
        ms = {p: 0.0 for p in PHASES}
        for s, e, _, corr in self.device:
            t = launch_at.get(corr)
            if t is None:
                continue
            for p, rs in ranges.items():
                j = bisect.bisect_right(rs, (t, float("inf"))) - 1
                if j >= 0 and rs[j][0] <= t <= rs[j][1]:
                    ms[p] += (e - s) / 1e6
        return ms

    def phase_ms(self, name: str) -> Optional[float]:
        return self._phase_ms.get(name)


def traced(fn: Callable[[], None], host: bool) -> Trace:
    """`fn` under the profiler: the device's records and the runtime calls,
    and with `host` every op and range of the host too."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU] if host or not torch.cuda.is_available() else []
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        with record_function(WINDOW):
            fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return Trace(prof.profiler.kineto_results.events(), wall)


@contextlib.contextmanager
def phase(name: str):
    """A named range for the trace."""
    from torch.profiler import record_function

    with record_function(name):
        yield
