"""Experiment logging (port of `multimodal_flows_tpu/utils/logger.py`):
console messages, the run directory, and the metric sinks of an experiment
directory.  `MetricsLogger` always writes `metrics.jsonl`, `metrics.csv`
and a TensorBoard event file under `tb/` (dependency-free: TFRecord
framing and the scalar Summary protos are encoded by hand); with a
`wandb_project` it adds a Weights & Biases sink when the `wandb` package
is installed and warns when it is not.  `wandb` is imported where it is
used.  Over several processes (`parallel/mesh.py`) rank 0 picks the run
directory and broadcasts it, and only rank 0 writes to the sinks.
"""

from __future__ import annotations

import csv
import json
import os
import struct
import time
import warnings
from typing import Any, Dict, List, Optional

from multimodal_flows_tpu_torch.parallel.mesh import broadcast_object, is_primary


class SimpleLogger:
    """Colored console logging; `condition=False` silences a call."""

    @staticmethod
    def info(message, condition: bool = True):
        if condition:
            print("\033[94m\033[1mINFO:\033[0m\033[00m", message)

    @staticmethod
    def warn(message, condition: bool = True):
        if condition:
            print("\033[31m\033[1mWARNING:\033[0m\033[00m", message)

    @staticmethod
    def warnings_off():
        for cat in (UserWarning, DeprecationWarning, FutureWarning):
            warnings.filterwarnings("ignore", category=cat)


def get_unique_dir(base_dir: str, exist_ok: bool = False) -> str:
    """`base_dir`, or when it exists (and `exist_ok` is false) the first
    free `base_dir_<n>`."""
    if os.path.exists(base_dir) and not exist_ok:
        counter = 1
        candidate = f"{base_dir}_{counter}"
        while os.path.exists(candidate):
            counter += 1
            candidate = f"{base_dir}_{counter}"
        return candidate
    return base_dir


def setup_logging_dir(base_dir: str, exist_ok: bool = False) -> str:
    """Create a unique run directory and return its path.  Over several
    processes rank 0 picks the name and creates it, and every rank returns
    rank 0's path (`broadcast_object_list`), even when `base_dir` exists."""
    path = None
    if is_primary():
        path = get_unique_dir(base_dir, exist_ok=exist_ok)
        os.makedirs(path, exist_ok=True)
    return broadcast_object(path)


class MetricSink:
    def log(self, step: int, metrics: Dict[str, float]) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class JSONLSink(MetricSink):
    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self._f = open(path, "a", buffering=1)

    def log(self, step, metrics):
        self._f.write(json.dumps({"step": step, "time": time.time(), **metrics}) + "\n")

    def close(self):
        self._f.close()


class CSVSink(MetricSink):
    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self.path = path
        self._fieldnames: Optional[List[str]] = None
        self._f = None
        self._writer = None

    def log(self, step, metrics):
        row = {"step": step, **metrics}
        if self._writer is None:
            self._fieldnames = list(row.keys())
            exists = os.path.exists(self.path)
            self._f = open(self.path, "a", newline="", buffering=1)
            self._writer = csv.DictWriter(self._f, fieldnames=self._fieldnames,
                                          extrasaction="ignore")
            if not exists:
                self._writer.writeheader()
        self._writer.writerow(row)

    def close(self):
        if self._f:
            self._f.close()


def _crc32c_table() -> List[int]:
    poly = 0x82F63B78  # Castagnoli, reflected
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        table.append(crc)
    return table


_CRC_TABLE = _crc32c_table()


def _crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), which the TFRecord framing requires (not
    zlib's CRC-32)."""
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = b""
    while True:
        b = n & 0x7F
        n >>= 7
        out += bytes([b | (0x80 if n else 0)])
        if not n:
            return out


def _pb_field(num: int, wire: int, payload: bytes) -> bytes:
    return _varint(num << 3 | wire) + payload


def _tb_event(step: int, wall_time: float, scalars: Dict[str, float]) -> bytes:
    """Hand-encoded tensorflow.Event proto with scalar Summary values
    (Event: wall_time=1 double, step=2 int64, summary=5; Summary.Value:
    tag=1 string, simple_value=2 float)."""
    values = b""
    for tag, v in scalars.items():
        val = (_pb_field(1, 2, _varint(len(tag.encode())) + tag.encode())
               + _pb_field(2, 5, struct.pack("<f", float(v))))
        values += _pb_field(1, 2, _varint(len(val)) + val)
    event = (_pb_field(1, 1, struct.pack("<d", wall_time))
             + _pb_field(2, 0, _varint(step))
             + _pb_field(5, 2, _varint(len(values)) + values))
    return event


class TensorBoardSink(MetricSink):
    """Dependency-free TensorBoard event-file writer (TFRecord framing +
    hand-encoded scalar Summary protos).  Point
    `tensorboard --logdir <experiment_dir>/tb` at it.
    """

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.{os.getpid()}"
        self._f = open(os.path.join(log_dir, fname), "ab", buffering=0)
        # leading Event{wall_time, file_version="brain.Event:2"} record
        ver = b"brain.Event:2"
        self._write_record(_pb_field(1, 1, struct.pack("<d", time.time()))
                           + _pb_field(3, 2, _varint(len(ver)) + ver))

    def _write_record(self, data: bytes) -> None:
        header = struct.pack("<Q", len(data))
        self._f.write(header
                      + struct.pack("<I", _masked_crc(header))
                      + data
                      + struct.pack("<I", _masked_crc(data)))

    def log(self, step, metrics):
        scalars = {k: float(v) for k, v in metrics.items()
                   if hasattr(v, "__float__")}
        if scalars:
            self._write_record(_tb_event(int(step), time.time(), scalars))

    def close(self):
        self._f.close()


class WandbSink(MetricSink):
    """Weights & Biases sink.  Needs the `wandb` package (the constructor
    raises ImportError without it; `MetricsLogger` catches that); honors
    `WANDB_MODE` and defaults to `offline`, so a machine without network
    still records a run directory that `wandb sync` can upload later.
    """

    def __init__(self, project: str, name: Optional[str] = None,
                 config: Optional[Dict[str, Any]] = None,
                 dir: Optional[str] = None):
        import wandb  # raises ImportError when not installed (caller gates)

        self._run = wandb.init(
            project=project, name=name, config=config or {}, dir=dir,
            mode=os.environ.get("WANDB_MODE", "offline"))

    def log(self, step, metrics):
        scalars = {k: float(v) for k, v in metrics.items()
                   if hasattr(v, "__float__")}
        if scalars:
            self._run.log(scalars, step=int(step))

    def close(self):
        self._run.finish()


class MetricsLogger:
    """Fan-out logger owning the experiment directory: every record goes to
    each sink (by default JSONL, CSV and TensorBoard, plus wandb when
    `wandb_project` is given and the package is there).  On ranks other
    than 0 it has no sink and writes nothing."""

    def __init__(self, experiment_dir: str, sinks: Optional[List[MetricSink]] = None,
                 wandb_project: Optional[str] = None,
                 wandb_name: Optional[str] = None,
                 wandb_config: Optional[Dict[str, Any]] = None):
        self.dir = experiment_dir
        if not is_primary():
            self.sinks = []
            return
        os.makedirs(experiment_dir, exist_ok=True)
        if sinks is None:
            sinks = [
                JSONLSink(os.path.join(experiment_dir, "metrics.jsonl")),
                CSVSink(os.path.join(experiment_dir, "metrics.csv")),
                TensorBoardSink(os.path.join(experiment_dir, "tb")),
            ]
        if wandb_project:
            try:
                sinks.append(WandbSink(wandb_project, name=wandb_name,
                                       config=wandb_config, dir=experiment_dir))
            except ImportError:
                SimpleLogger.warn(
                    "use_wandb requested but the wandb package is not "
                    "installed; continuing with JSONL/CSV/TensorBoard sinks")
        self.sinks = sinks

    def log(self, step: int, metrics: Dict[str, Any]) -> None:
        clean = {k: (float(v) if hasattr(v, "__float__") else v) for k, v in metrics.items()}
        for s in self.sinks:
            s.log(step, clean)

    def close(self) -> None:
        for s in self.sinks:
            s.close()
