"""Profiling helpers (PyTorch port of `multimodal_flows_tpu/utils/profiling.py`,
with the card's timers that `chip_smoke.py` uses) and the port's spans and
counters.

- `span(name)`: a named interval of the program's host work, kept in memory
  while tracing is on (during any `torch.profiler` session, or after
  `record_spans(True)`) and, under the profiler, also a `record_function`
  range of the same name; a shared no-op when tracing is off;
- `take_spans()` / `peek_spans()`: the buffered spans, emptied or not;
  `requests(spans, root)`: the spans grouped by request;
- `declare(prefix, *names)` at a module's import, then `count(name, n)`:
  the port's counters, one registry by dotted name; `take_counters()` /
  `peek_counters()` read them and `spans.dropped`, zeroed or not;
- `captured_counts()` around a CUDA graph's capture, which runs nothing:
  what it counted, taken back out, for `add_counts` at each replay;
- `tracing()`: whether spans are kept now (counters that only tracing
  reads count while it is true);
- `trace(logdir)`: a `torch.profiler` trace of the block, written as a
  Chrome trace into `logdir` (a no-op for None);
- `force_completion(tree)`: waits for the device and returns the sum of
  every float tensor of a nested structure, a host number;
- `median_device_ms(fns)`: the median CUDA-event device time of each fn,
  run in turns with the stream held while the host enqueues, so the time is
  the kernels' own and not the host's launch overhead;
- `profile_steps`: train steps under `torch.profiler`, their device time
  split into forward (the trainer's `train.loss` spans), optimizer
  (`train.update`) and backward (the rest), the busy share's numerator,
  the launches and the kernels by name.

The spans' stamps are `time.time_ns()`, the clock of the profiler's
events, so a span lines up with the device records of the same trace.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import os
import threading
import time
from collections import deque
from typing import (Callable, Deque, Dict, Iterator, List, Mapping, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

# GPU clock cycles (about 1 ms) that a sleep kernel holds the stream before
# each timed call, so the host has enqueued the call's kernels when the
# start event runs
HOLD_CYCLES = 2_000_000

#: the most spans the buffer holds; past it the oldest are dropped, and
#: counted under `spans.dropped`
SPAN_BUFFER = 1 << 18


class Span(NamedTuple):
    """One span: `start_ns` and `end_ns` on `time.time_ns()`'s clock,
    `parent` the enclosing span's name (None at the top), `root` the number
    shared by every span of one request (its top-level span's)."""

    name: str
    start_ns: int
    end_ns: int
    parent: Optional[str]
    root: int


_record = False
_spans: Deque[Span] = deque(maxlen=SPAN_BUFFER)
_dropped = 0
_roots = itertools.count(1)
# set by torch.profiler while a session is active
_autograd_profiler = torch.autograd.profiler


class _Stack(threading.local):
    def __init__(self):
        self.open: List["_Span"] = []


_stack = _Stack()


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "parent", "root", "start_ns", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        open_ = _stack.open
        if open_:
            self.parent, self.root = open_[-1].name, open_[-1].root
        else:
            self.parent, self.root = None, next(_roots)
        open_.append(self)
        self.range = None
        if _autograd_profiler._is_profiler_enabled:
            self.range = _autograd_profiler.record_function(self.name)
            self.range.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        global _dropped
        end_ns = time.time_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        _stack.open.pop()
        if len(_spans) == _spans.maxlen:
            _dropped += 1
        _spans.append(Span(self.name, self.start_ns, end_ns, self.parent, self.root))
        return False


def tracing() -> bool:
    """Whether spans are kept: a profiler session is active, or
    `record_spans(True)` was called."""
    return _record or _autograd_profiler._is_profiler_enabled


def span(name: str):
    """A context manager that records the block as the span `name` while
    tracing is on; otherwise the shared no-op (no allocation, no profiler
    range, no device call)."""
    if _record or _autograd_profiler._is_profiler_enabled:
        return _Span(name)
    return _NO_SPAN


def spanned(name: str):
    """Decorator: every call of the function is the span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def record_spans(on: bool) -> None:
    """Keep spans without a profiler session (`on`), or only during one."""
    global _record
    _record = bool(on)


def take_spans() -> List[Span]:
    """The buffered spans in the order they ended; empties the buffer."""
    out = list(_spans)
    _spans.clear()
    return out


def peek_spans() -> List[Span]:
    """The buffered spans in the order they ended; the buffer keeps them."""
    return list(_spans)


def requests(spans: Sequence[Span], root: str, after_ns: int = 0) -> List[List[Span]]:
    """The spans of each request whose top-level span is named `root` and
    starts after `after_ns`, a list a request, in the order they started."""
    tops = sorted((s.start_ns, s.root) for s in spans
                  if s.parent is None and s.name == root and s.start_ns > after_ns)
    by_root: Dict[int, List[Span]] = {r: [] for _, r in tops}
    for s in spans:
        if s.root in by_root:
            by_root[s.root].append(s)
    return [by_root[r] for _, r in tops]


#: every counter of the port by dotted name but the span buffer's own
_counters: Dict[str, int] = {}


def declare(prefix: str, *names: str) -> Dict[str, str]:
    """Declare the counters `prefix.name` at 0, so that `peek_counters()`
    holds them before their first count; returns {name: dotted name}."""
    dotted = {name: f"{prefix}.{name}" for name in names}
    for key in dotted.values():
        _counters.setdefault(key, 0)
    return dotted


def count(name: str, n: int = 1) -> None:
    """Add `n` to the declared counter `name` (dotted)."""
    _counters[name] += n


def peek_counters() -> Dict[str, int]:
    """Every counter of the port by dotted name, declared when its module
    was imported (`k1.segments`, `k2_bf16.bias`, `gpt_decode.graph_steps`,
    `lund.pairs`, `lund_mlp.kernel`, ...), and `spans.dropped`; the
    counters keep their values."""
    out = dict(_counters)
    out["spans.dropped"] = _dropped
    return out


def take_counters() -> Dict[str, int]:
    """`peek_counters()`, every counter then set to zero."""
    global _dropped
    out = peek_counters()
    for key in _counters:
        _counters[key] = 0
    _dropped = 0
    return out


@contextlib.contextmanager
def captured_counts() -> Iterator[Dict[str, int]]:
    """Around the capture of a CUDA graph: yields a dict that holds, after
    the block, what the block counted, by dotted name.  A capture runs
    nothing, so that is taken back out of the registry; `add_counts` adds
    it at each replay."""
    before, change = dict(_counters), {}
    yield change
    change.update((key, n - before.get(key, 0)) for key, n in _counters.items()
                  if n != before.get(key, 0))
    for key, n in change.items():
        _counters[key] -= n


def add_counts(change: Mapping[str, int]) -> None:
    """Add `change` (from `captured_counts`) to the registry: one replay."""
    for key, n in change.items():
        _counters[key] += n


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
    in a synchronize.  The device time of the trainer's `train.loss` and
    `train.update` spans is the forward and the optimizer; the rest of the
    top-level events' device time is the backward (autograd launches it
    from its own thread)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            step(i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    events = prof.events()
    phases = {phase: sum(e.device_time_total for e in events
                         if e.name == name and e.device_type.name == "CPU") / n / 1e3
              for phase, name in (("forward", "train.loss"), ("optimizer", "train.update"))}
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
